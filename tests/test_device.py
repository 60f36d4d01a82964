"""Device resolution, the compile cache, and the GPU-only kernel check.

The resolution tests pin ``device.py``: an absent target platform is
refused instead of running somewhere else, and device memory is read, not
guessed.  The ``gpu``-marked test runs the implicit matvec compiled for the
card and skips where JAX finds none.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from plssvm_sparse_fp22 import device
from plssvm_sparse_fp22.exceptions import PLSSVMError, UnsupportedBackendError
from plssvm_sparse_fp22.io.libsvm import ParsedData
from plssvm_sparse_fp22.models import make_csvm
from plssvm_sparse_fp22.params import Parameter
from plssvm_sparse_fp22.types import (BackendType, KernelType, TargetPlatform,
                                      list_available_backends,
                                      list_available_target_platforms)
from plssvm_sparse_fp22.utils import compilation_cache as cc
from plssvm_sparse_fp22.utils import oracle

from utils import make_blobs


def _params(**kw):
    X, y = make_blobs(40, 6, seed=2)
    p = Parameter(kernel=KernelType.rbf, gamma=0.2, print_info=False, **kw)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    return p


def test_backend_names():
    """``automatic`` names the one XLA program; ``xla`` and the
    reference's backend names are aliases for it."""
    assert list_available_backends() == [BackendType.automatic]
    for name in ("cuda", "OpenMP", "sycl", "XLA", "automatic"):
        assert BackendType.from_string(name) == BackendType.automatic


def test_pallas_backend_without_gpu_raises(capsys):
    """The fused Pallas kernel lost to XLA on the H100 and was removed
    with its option: ``pallas`` is refused everywhere, by the parser and
    by the CLI."""
    from plssvm_sparse_fp22.cli.train import main as train

    with pytest.raises(UnsupportedBackendError, match="pallas"):
        BackendType.from_string("pallas")
    data = os.path.join(os.path.dirname(__file__), "data", "reference",
                        "libsvm", "5x4.libsvm")
    with pytest.raises(SystemExit):
        train(["-q", "-b", "pallas", data])
    assert "pallas" in capsys.readouterr().err


def test_target_platform_names():
    assert TargetPlatform.from_string("gpu_nvidia") == TargetPlatform.gpu_nvidia
    assert TargetPlatform.from_string("CPU") == TargetPlatform.cpu
    assert list_available_target_platforms() == [
        TargetPlatform.automatic, TargetPlatform.cpu, TargetPlatform.gpu_nvidia]
    for name in ("gpu_amd", "gpu_intel", "bogus"):
        with pytest.raises(UnsupportedBackendError):
            TargetPlatform.from_string(name)


def test_absent_target_platform_raises():
    device.check_target(TargetPlatform.cpu)
    device.check_target(TargetPlatform.automatic)
    with pytest.raises(UnsupportedBackendError, match="gpu_nvidia"):
        make_csvm(_params(target=TargetPlatform.gpu_nvidia))
    svm = make_csvm(_params(target=TargetPlatform.cpu))
    svm.learn()
    assert svm.accuracy() > 0.9


def test_device_memory_bytes(monkeypatch):
    # the CPU reports the host's physical memory
    assert device.device_memory_bytes() > 1 << 28

    class Silent:
        platform = "gpu"
        device_kind = "Unknown card"

        def memory_stats(self):
            return None

    class Reporting(Silent):
        def memory_stats(self):
            return {"bytes_limit": 60 << 30}

    monkeypatch.setattr(jax, "devices", lambda: [Reporting()])
    assert device.device_memory_bytes() == 60 << 30
    monkeypatch.setattr(jax, "devices", lambda: [Silent()])
    with pytest.raises(PLSSVMError, match="no memory limit"):
        device.device_memory_bytes()


@pytest.fixture
def fake_gpu_cache(monkeypatch):
    """Enable the cache as on a GPU, restoring JAX's cache config after."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("PLSSVM_NO_COMPILATION_CACHE", raising=False)
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_uses_env_dir(fake_gpu_cache, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no directory of
    its own (JAX reads the variable itself)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_checkout_dir(fake_gpu_cache, monkeypatch):
    """Without the variable the cache goes to one fixed directory inside
    the checkout, which git ignores."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cc.enable_compilation_cache() == cc.CHECKOUT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == cc.CHECKOUT_CACHE_DIR
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.CHECKOUT_CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_compile_cache_off_on_cpu():
    assert cc.enable_compilation_cache() is None


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [KernelType.linear, KernelType.polynomial,
                                    KernelType.rbf])
def test_implicit_matvec_exact_on_gpu(gpu, kernel):
    """XLA's implicit Gram matvec as compiled for the card, at the default
    (exact f32) tier, vs the f64 oracle: relative max error 1e-5 of
    max|Kv| (TF32 would miss it by an order of magnitude)."""
    from plssvm_sparse_fp22.ops.matvec import build_operator

    rng = np.random.default_rng(0)
    D, f = 1024, 200
    X = rng.uniform(-1, 1, size=(D, f))
    v = rng.normal(size=D)
    hyper = dict(degree=3, gamma=1.0 / f, coef0=1.0)
    op = build_operator(kernel, jnp.asarray(X, jnp.float32),
                        jnp.zeros(D, jnp.float32), jnp.ones(D, jnp.float32),
                        0.0, 0.0, mode="implicit", **hyper)
    got = np.asarray(op.matvec(jnp.asarray(v, jnp.float32)), np.float64)
    want = oracle.kernel_matrix(kernel, X, X, **hyper) @ v
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("target,ok", [
    (TargetPlatform.automatic, True),
    (TargetPlatform.cpu, True),
    (TargetPlatform.gpu_nvidia, False),
])
def test_check_target(target, ok):
    if ok:
        device.check_target(target)
    else:
        with pytest.raises(UnsupportedBackendError):
            device.check_target(target)


@pytest.mark.parametrize("kernel,dept,dtype,budget,scale,want", [
    (KernelType.linear, 10**6, np.float32, None, 1, "linear"),
    (KernelType.rbf, 4096, np.float32, None, 1, "cached"),
    (KernelType.rbf, 65535, np.float32, None, 1, "implicit"),  # 16 GiB K
    (KernelType.polynomial, 32767, np.float64, None, 1, "cached"),
    (KernelType.rbf, 4096, np.float64, 4096 * 4096 * 8 - 1, 1, "implicit"),
    (KernelType.rbf, 65535, np.float32, None, 4, "cached"),  # 4-way slab
])
def test_choose_mode_policy(monkeypatch, kernel, dept, dtype, budget, scale,
                            want):
    """Cached whenever K fits the (per-device) budget, at any feature
    width: on the H100 the cached GEMV beat recomputing K above f ~ 9."""
    from plssvm_sparse_fp22.ops.matvec import choose_mode

    if budget is None:
        monkeypatch.delenv("PLSSVM_K_CACHE_BYTES", raising=False)
    else:
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", str(budget))
    assert choose_mode(kernel, dept, dtype, budget_scale=scale) == want


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir_resolution(monkeypatch, tmp_path, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cc.cache_dir() == cc.CHECKOUT_CACHE_DIR
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
        assert cc.cache_dir() == str(tmp_path / env_dir)


def test_chip_smoke_refuses_cpu(capsys):
    """The bring-up script stops with a failure, and prints no result
    line, where JAX finds no GPU."""
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert "needs a GPU" in str(exc.value)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("kind,known", [("NVIDIA H100 80GB HBM3", True),
                                        ("cpu", False)])
def test_bench_peak_table(kind, known):
    """One row per card with its source; an unknown card is an error."""
    import bench

    if known:
        peaks = bench.device_peaks(kind)
        assert peaks["bf16_tflops"] == 989.0 and peaks["hbm_gbs"] == 3350.0
    else:
        with pytest.raises(SystemExit, match="no published peaks"):
            bench.device_peaks(kind)
