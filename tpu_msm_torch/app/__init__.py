"""The MSM offload service on the port: a TCP server (`service`) and its
wire format (`protocol`), byte-compatible with `example_app/`."""
