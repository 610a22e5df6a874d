"""The port's CUDA build cache (`tpu_msm_torch/_build.py`,
`tpu_msm_torch/utils/cache.py`) on the CPU: the build directory moves
with `enable_compile_cache`, and processes that build at once compile
once. `nvcc` is a stub that writes its output file and counts its calls."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

from tpu_msm_torch import _build
from tpu_msm_torch.utils import cache, window

REPO = Path(__file__).resolve().parent.parent


def test_enable_compile_cache_moves_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(_build.BUILD_DIR_ENV, "")   # restored after
    monkeypatch.delenv(window.CACHE_ENV, raising=False)
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR.resolve()
    assert cache.enable_compile_cache() == str(_build.DEFAULT_BUILD_DIR)
    target = tmp_path / "kernels"
    assert cache.enable_compile_cache(str(target)) == str(target)
    assert os.environ[_build.BUILD_DIR_ENV] == str(target)
    assert _build.build_dir() == target
    assert window.cache_path() == str(target / "autotune_cache.json")
    with _build.build_lock() as d:
        assert d == target and (target / "lock").exists()


STUB = """\
#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["STUB_COUNT"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
time.sleep(0.3)
with open(out, "w") as f:
    f.write("built by the stub\\n")
"""

BUILDER = """\
import os, sys, time
sys.path.insert(0, {repo!r})
from tpu_msm_torch import _build
_build._nvcc = lambda: {stub!r}
open(os.path.join({tmp!r}, "ready%s" % sys.argv[1]), "w").close()
t0 = time.time()
while not all(os.path.exists(os.path.join({tmp!r}, "ready%d" % i))
              for i in (0, 1)):
    if time.time() - t0 > 60:
        raise SystemExit("the other builder never started")
    time.sleep(0.01)
print(_build.build())
"""


def test_concurrent_builds_compile_once(tmp_path):
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(0o755)
    build_dir, count = tmp_path / "build", tmp_path / "count"
    env = dict(os.environ, STUB_COUNT=str(count))
    env[_build.BUILD_DIR_ENV] = str(build_dir)
    code = BUILDER.format(repo=str(REPO), stub=str(stub), tmp=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(build_dir / "libkernels.so")
    calls = count.read_text().splitlines()
    cu, _ = _build._sources()
    assert len(calls) == len(cu) + 1, "\n".join(calls)
    assert sum("-shared" in c for c in calls) == 1
    assert (build_dir / "sources.sha256").read_text() == _build._digest()
    assert (build_dir / "libkernels.so").read_text() == "built by the stub\n"
    assert not (build_dir / "libkernels.so.tmp").exists()
    assert sorted(p.name for p in build_dir.glob("*.o")) == sorted(
        s.stem + ".o" for s in cu)
