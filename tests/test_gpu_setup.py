"""Device setup: the compile-cache placement, the smoke script's refusal to
run without a GPU, and the GPU parity checks of chip_smoke.py phase (b).

The parity tests carry the `gpu` marker and decide inside a fixture whether
a card is present: on the CPU they skip, on the card the same checks run as
phase (b) of `python chip_smoke.py`."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(extra)
    return env


@pytest.mark.parametrize("from_env", [False, True])
def test_compile_cache_placement(tmp_path, from_env):
    env = _env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)) if from_env else _env()
    r = subprocess.run(
        [sys.executable, "-c", "import orbslam3lib_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    want = str(tmp_path) if from_env else os.path.join(ROOT, ".jax_cache")
    assert r.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("isolated", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, isolated):
    cwd = ROOT
    if isolated:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.fixture(scope="module")
def gpu():
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; these checks run on the card as phase (b) "
                    "of chip_smoke.py")
    return devs[0]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def frame(gpu, smoke):
    return smoke.bench_frame()


@pytest.mark.gpu
def test_gpu_fast_nms_parity(gpu, smoke, frame):
    import jax
    smoke.check_fast(gpu, jax.devices("cpu")[0], frame)


@pytest.mark.gpu
def test_gpu_knn2_parity(gpu, smoke):
    smoke.check_knn(gpu)


@pytest.mark.gpu
def test_gpu_pyramid_parity(gpu, smoke, frame):
    smoke.check_pyramid(gpu, frame)


@pytest.mark.gpu
def test_gpu_extract_parity(gpu, smoke, frame):
    import jax
    smoke.check_extract(gpu, jax.devices("cpu")[0], frame)


@pytest.mark.gpu
def test_gpu_geometry_parity(gpu, smoke):
    import jax
    smoke.check_geometry(gpu, jax.devices("cpu")[0])
