"""Host-side native code: the C++ CPU MSM (`cpu_msm`)."""
