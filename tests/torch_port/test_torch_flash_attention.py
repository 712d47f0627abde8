"""horovod_tpu_torch.ops.flash_attention against the JAX package's Pallas
flash attention (interpret mode on the CPU, as tests/test_flash_attention.py
runs it): the forward's (out, lse), the gradients of both backward passes,
the errors, and the dispatch rule (CPU tensors take the plain versions; any
other tensor takes the kernel or raises).  Tolerances are those of
tests/test_flash_attention.py."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import flash_attention as JF
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops import flash_attention as TF


def _qkv(B=2, S=128, H=4, HK=2, D=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, HK, D).astype(np.float32),
            rng.randn(B, S, HK, D).astype(np.float32))


def _torch(*arrays, dtype=torch.float32, grad=False):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_pallas(causal):
    q, k, v = _qkv()
    out, lse = TF.attention_forward(*_torch(q, k, v), causal=causal)
    r_out, r_lse = JF._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, 64, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse),
                               rtol=2e-5, atol=2e-5)


def _grads_torch(q, k, v, causal, block):
    tq, tk, tv = _torch(q, k, v, grad=True)
    out = TF.flash_attention(tq, tk, tv, causal, block, block)
    out.square().sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _grads_jax(q, k, v, causal, block):
    f = lambda q, k, v: jnp.sum(
        JF.flash_attention(q, k, v, causal, block, block) ** 2)
    return jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def test_gradients_match_pallas():
    q, k, v = _qkv(S=64)
    for name, a, b in zip("qkv", _grads_torch(q, k, v, True, 32),
                          _grads_jax(q, k, v, True, 32)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_gqa_and_noncausal(causal):
    q, k, v = _qkv(B=2, S=64, H=8, HK=2, D=16, seed=7)
    for name, a, b in zip("qkv", _grads_torch(q, k, v, causal, 16),
                          _grads_jax(q, k, v, causal, 16)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-5,
                                   err_msg=f"d{name} causal={causal}")


def test_backward_bf16_inputs():
    """bf16 in, bf16 gradients out, close to the JAX package's bf16
    gradients (tests/test_flash_attention.py's 0.1)."""
    rng = np.random.RandomState(8)
    mk = lambda: rng.randn(1, 32, 2, 8).astype(np.float32)
    q, k, v = mk(), mk(), mk()
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16, grad=True)
    TF.flash_attention(tq, tk, tv, True, 16, 16).float().sum().backward()
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = jax.grad(lambda q, k, v: jnp.sum(JF.flash_attention(
        q, k, v, True, 16, 16).astype(jnp.float32)), argnums=(0, 1, 2))(
            jb(q), jb(k), jb(v))
    for t, r in zip((tq, tk, tv), ref):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(r, np.float32),
                                   rtol=0.1, atol=0.1)


def test_rejects_indivisible_seq():
    tq, tk, tv = _torch(*_qkv(S=96))
    with pytest.raises(ValueError, match="divide"):
        TF.flash_attention(tq, tk, tv, True, 64, 64)


def test_rejects_non_divisible_gqa():
    q, _, _ = _qkv(H=8, HK=2)
    _, k, v = _qkv(H=8, HK=3)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        TF.flash_attention(*_torch(q, k, v), True, 64, 64)


def test_cpu_dispatches_to_plain_versions(monkeypatch):
    called = []
    for name in ("attention_forward_plain", "attention_dq_plain",
                 "attention_dkv_plain"):
        fn = getattr(TF, name)
        monkeypatch.setattr(
            TF, name,
            lambda *a, _fn=fn, _n=name, **kw: called.append(_n) or _fn(*a, **kw))
    before = dict(TF.LAUNCHES)
    tq, tk, tv = _torch(*_qkv(S=64), grad=True)
    TF.flash_attention(tq, tk, tv, True, 32, 32).sum().backward()
    assert called == ["attention_forward_plain", "attention_dq_plain",
                      "attention_dkv_plain"]
    assert TF.LAUNCHES == before  # no kernel launched


def test_non_cpu_tensor_without_kernel_library_raises(monkeypatch):
    """A tensor that is not on the CPU never falls back to the plain
    version: with the library missing, the call raises."""
    def missing():
        raise RuntimeError("kernel library missing")
    monkeypatch.setattr(_kernels, "load", missing)
    q, k, v = (torch.empty(1, 64, 2, 64, device="meta") for _ in range(3))
    with pytest.raises(RuntimeError, match="kernel library missing"):
        TF.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="kernel library missing"):
        TF.attention_dq(q, k, v, q, None, None)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_kernels, "_LIB", None)
    monkeypatch.setattr(_kernels, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.load()


def test_kernel_wrapper_rejects_cpu_tensors(monkeypatch):
    monkeypatch.setattr(_kernels, "load", lambda: None)
    tq, tk, tv = _torch(*_qkv(D=64))
    with pytest.raises(ValueError, match="not a CUDA device"):
        TF.flash_forward_cuda(tq, tk, tv)



def test_kernel_build_dir_checkout_or_user_cache(monkeypatch, tmp_path):
    """A source checkout builds into its own build/; an installed package,
    whose directory may be read-only or shared, into the user's cache."""
    checkout = tmp_path / "checkout"
    (checkout / "horovod_tpu_torch").mkdir(parents=True)
    (checkout / "pyproject.toml").write_text("")
    monkeypatch.setattr(_kernels, "_PKG", str(checkout / "horovod_tpu_torch"))
    assert _kernels._build_dir() == str(checkout / "build" / "torch_kernels")
    site = tmp_path / "site-packages" / "horovod_tpu_torch"
    site.mkdir(parents=True)
    monkeypatch.setattr(_kernels, "_PKG", str(site))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _kernels._build_dir() == str(tmp_path / "cache" / "horovod_tpu_torch")


def _chip_smoke():
    """chip_smoke.py, the repository's card check, as a module."""
    path = os.path.join(os.path.dirname(__file__), "..", "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_check_rejects_a_dropped_tile():
    """chip_smoke.py's comparison of a kernel with its plain version fails
    a dk/dv that misses every k tile past S/2: on a causal sequence those
    rows are small against max|ref|, so only the per-tile error sees them."""
    cs = _chip_smoke()
    q, k, v = _torch(*_qkv(B=1, S=512, H=4, HK=2, D=64), dtype=torch.bfloat16)
    do = torch.tensor(np.random.RandomState(1).randn(1, 512, 4, 64),
                      dtype=torch.bfloat16)
    out, lse = TF.attention_forward_plain(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = TF.attention_dkv_plain(q, k, v, do, lse, delta, True)
    for name, good in (("dk", dk), ("dv", dv)):
        assert cs.check_output(name, good, good, torch.bfloat16)[2]
        bad = good.clone()
        bad[:, 256:] = 0
        err, tile, ok, _ = cs.check_output(name, bad, good, torch.bfloat16)
        assert not ok and tile == pytest.approx(1.0)


# Every shape the first kernels' wrapper accepted: bf16 with S a multiple of
# 64, fp32 with S a multiple of 32, D in {64, 128}, H a multiple of HK.
@pytest.mark.parametrize("dtype,B,S,H,HK,D", [
    (torch.bfloat16, 4, 2048, 32, 8, 64),
    (torch.bfloat16, 1, 64, 2, 1, 64),
    (torch.bfloat16, 2, 192, 8, 2, 64),
    (torch.bfloat16, 1, 320, 8, 4, 128),
    (torch.bfloat16, 2, 1024, 8, 8, 128),
    (torch.bfloat16, 2, 1024, 32, 4, 64),
    (torch.float32, 2, 256, 8, 2, 64),
    (torch.float32, 1, 32, 4, 2, 128),
    (torch.float32, 1, 96, 2, 2, 64),
])
def test_kernel_shapes_accepts_every_supported_shape(dtype, B, S, H, HK, D):
    assert TF.kernel_shapes((B, S, H, D), (B, S, HK, D), (B, S, HK, D),
                            dtype) == (B, S, H, HK, D)


@pytest.mark.parametrize("dtype,q,kv,match", [
    (torch.bfloat16, (1, 96, 2, 64), (1, 96, 2, 64), "multiple of its 64"),
    (torch.float32, (1, 48, 2, 64), (1, 48, 2, 64), "multiple of its 32"),
    (torch.bfloat16, (1, 64, 2, 32), (1, 64, 2, 32), "head dim"),
    (torch.bfloat16, (1, 64, 6, 64), (1, 64, 4, 64), "multiple of kv heads"),
    (torch.float16, (1, 64, 2, 64), (1, 64, 2, 64), "bf16 or fp32"),
    (torch.bfloat16, (1, 64, 2, 64), (1, 128, 2, 64), "does not match"),
    (torch.bfloat16, (64, 2, 64), (1, 64, 2, 64), r"\[B,S,H,D\]"),
])
def test_kernel_shapes_refuses(dtype, q, kv, match):
    with pytest.raises(ValueError, match=match):
        TF.kernel_shapes(q, kv, kv, dtype)


def test_kernel_wrapper_checks_device_before_shapes(monkeypatch):
    """A CPU tensor never reaches the shape rules: the device check comes
    first, whatever the shape."""
    monkeypatch.setattr(_kernels, "load", lambda: None)
    tq, tk, tv = _torch(*_qkv(S=96, D=64))
    with pytest.raises(ValueError, match="not a CUDA device"):
        TF.flash_dkv_cuda(tq, tk, tv, tq, None, None)


PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114fwd_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114fwd_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113dq_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113dq_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiiif
    24 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 2048 bytes smem, 400 bytes cmem[0]
ptxas info    : Compile time = 12.345 ms
"""


def test_parse_ptxas_reads_registers_and_spills():
    cs = _chip_smoke()
    info = cs.parse_ptxas(PTXAS_SAMPLE)
    assert len(info) == 2
    fwd = next(v for k, v in info.items() if "fwd_mma_kernelILi64E" in k)
    dq = next(v for k, v in info.items() if "dq_mma_kernelILi64E" in k)
    assert fwd == {"registers": 124, "spill_bytes": 0}
    assert dq == {"registers": 255, "spill_bytes": 28}
    # every instantiation chip_smoke reports is named by one fragment
    for fragment in cs.INSTANCES.values():
        assert sum(fragment in k for k in info) <= 1


# Every instantiation of the three kernels as nvcc mangles it (bf16 and
# fp32, D = 64 and 128), and as the profiler shows one demangled.
_BF16 = "PK13__nv_bfloat16S3_S3_"
_MANGLED = {
    "fwd_mma_kernel": _BF16 + "PS1_Pfiiiif",
    "dq_mma_kernel": _BF16 + "S3_PKfS5_PS1_iiiif",
    "dkv_mma_kernel": _BF16 + "S3_PKfS5_PS1_S6_iiiif",
    "fwd_kernel": "PKfS2_S2_PfS3_iiiif",
    "dq_kernel": "PKfS2_S2_S2_S2_S2_Pfiiiif",
    "dkv_kernel": "PKfS2_S2_S2_S2_S2_PfS3_iiiif",
}


@pytest.mark.parametrize("key,kind", [
    *((f"_ZN12_GLOBAL__N_1{len(fn)}{fn}ILi{D}EEEv{args}", "flash attention")
      for fn, args in _MANGLED.items() for D in (64, 128)),
    ("void (anonymous namespace)::dq_mma_kernel<64>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int, int, float)",
     "flash attention"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopA_TNT", "matrix products"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matrix products"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "nccl"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>>(int, ...)", "other"),
])
def test_kernel_kind_books_each_kernel(key, kind):
    """chip_smoke.py books a profiled kernel's time by its name: every
    instantiation of the three attention kernels as flash attention."""
    assert _chip_smoke().kernel_kind(key) == kind
