"""The port's flash-attention dropout stream and backward
(deepsense6g_tii_tpu_torch/ops/flash_attention.py) against the JAX
package's: the hash stream bit for bit, the kernels' integer keep
threshold against the float compare, the forward with dropout and the
gradients against the Pallas kernels in interpret mode, merged and split
(also in bf16 at the production length, T = 962), and the plain backward
against torch autograd.  The CUDA route's argument packing is held to the
C entries' declarations in csrc/.

On a CPU tensor the port's wrappers run their plain versions, which is what
these tests hold against JAX; the CUDA kernels are held against the same
plain versions on the card by chip_smoke.py.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.ops import flash_attention as jfa
from deepsense6g_tii_tpu_torch.ops import _build
from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

# the bounds of tests/test_flash_attention.py: f32 forward (streaming vs
# materialised softmax) and gradients
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=3e-5, atol=3e-6)
U32 = 0xFFFFFFFF


def _qkv(seed, b=1, h=2, t=70, d=64):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=(b, h, t, d)) * 0.3).astype(np.float32)
                 for _ in range(4))


def _seed(key) -> int:
    return int(jfa.derive_seed(key)[0])


# -- the dropout stream ------------------------------------------------------

@pytest.mark.parametrize("block", [128, 512])
@pytest.mark.parametrize("t", [70, 130, 600])
@pytest.mark.parametrize("seed", [0, 12345, -7, -2 ** 31])
def test_stream_equals_jax_bit_for_bit(seed, t, block):
    want = jfa.dropout_scale_reference(jnp.asarray(seed, jnp.int32), 2, t,
                                       0.1, block=block)
    got = fa.dropout_scale_reference(seed, 2, t, 0.1, block=block)
    assert got.dtype == torch.float32 and got.shape == (2, t, t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fmix32(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & U32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & U32
    return x ^ (x >> 16)


def test_uniform_hash_wraps_like_uint32():
    """The int64 products overflow for ids near 2^32 ((2^32-1)·0xC2B2AE35 >
    2^63); the masked low 32 bits must still be the uint32 product."""
    ids = [0, 1, 2 ** 31 - 1, 2 ** 31, 0xDEADBEEF, U32 - 1, U32]
    assert (U32 * 0xC2B2AE35) > 2 ** 63
    for seed in (-2 ** 31, -1, 0, 0x7FFFFFFF):
        got = fa.uniform_hash(torch.tensor(ids, dtype=torch.int64), seed)
        want = [(_fmix32(i ^ (seed & U32)) >> 8) * 2.0 ** -24 for i in ids]
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want, np.float32))


def test_keep_rate_and_cpu_mask_wrapper():
    m = fa.dropout_mask(3, 4, 256, 0.1, block=128, device="cpu")
    np.testing.assert_array_equal(
        m.numpy(), fa.dropout_scale_reference(3, 4, 256, 0.1, 128).numpy())
    assert abs(float((m > 0).float().mean()) - 0.9) < 0.01
    assert set(np.unique(m.numpy())) == {0.0, np.float32(1) / np.float32(0.9)}


def test_stream_depends_on_the_padded_length():
    # the id formula uses t_pad, so the block changes the bits
    a = fa.dropout_scale_reference(5, 1, 130, 0.5, block=128)
    b = fa.dropout_scale_reference(5, 1, 130, 0.5, block=512)
    assert (a != b).any()


# -- forward with dropout and gradients against the Pallas kernels -----------

@pytest.mark.parametrize("t,p", [(70, 0.1), (200, 0.25)])
def test_forward_with_dropout_matches_pallas(t, p):
    q, k, v, _ = _qkv(t, t=t)
    key = jax.random.PRNGKey(t)
    sm = 64 ** -0.5
    want = jfa.flash_mha(*map(jnp.asarray, (q, k, v)), sm_scale=sm,
                         dropout_p=p, rng=key, block=128, interpret=True)
    got = fa.flash_mha(*map(torch.from_numpy, (q, k, v)), sm_scale=sm,
                       dropout_p=p, seed=_seed(key), block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _jax_bwd_mode(monkeypatch, mode, d):
    """Sets the JAX package's backward (DEEPSENSE_FLASH_BWD, which its
    _bwd_mode reads while tracing) to ``mode``: the Pallas merged kernel or
    the dq + dkv pair, the two the port's kernels are held to."""
    monkeypatch.setenv("DEEPSENSE_FLASH_BWD", mode)
    assert jfa._bwd_mode(1024, d) == mode


@pytest.mark.parametrize("mode", ["merged", "split"])
@pytest.mark.parametrize("t,d", [(130, 64), (200, 32)])
@pytest.mark.parametrize("p", [0.0, 0.25])
def test_grads_match_pallas(monkeypatch, t, d, p, mode):
    _jax_bwd_mode(monkeypatch, mode, d)
    q, k, v, w = _qkv(100 * t + d, t=t, d=d)
    key = jax.random.PRNGKey(3)
    sm = d ** -0.5

    def jax_loss(q, k, v):
        return jnp.sum(jfa.flash_mha(q, k, v, sm_scale=sm, dropout_p=p,
                                     rng=key if p else None, block=128,
                                     interpret=True) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_mha(qt, kt, vt, sm_scale=sm, dropout_p=p,
                     seed=_seed(key) if p else None, block=128)
    (o * torch.from_numpy(w)).sum().backward()
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL,
                                   err_msg=f"d{name}")


# -- the plain backward --------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.3])
def test_plain_backward_equals_autograd(p):
    q, k, v, w = (torch.from_numpy(x).double() for x in _qkv(9, t=45, d=16))
    sm = 0.25
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_mha_reference(q, k, v, sm, p, seed=11, block=128)
    (o * w).sum().backward()
    with torch.no_grad():
        got = fa.flash_mha_bwd_reference(q, k, v, o, lse, w, sm, p, 11, 128)
    for a, b, name in zip(got, (q.grad, k.grad, v.grad), "qkv"):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12,
                                   msg=f"d{name}")


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_flash_attention_gradcheck(p):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1, 9, 8, dtype=torch.float64, generator=g,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_mha(q, k, v, dropout_p=p,
                                     seed=-5 if p else None, block=16),
        (q, k, v))


def test_bf16_backward_keeps_dtype():
    q, k, v = (torch.from_numpy(x).bfloat16().requires_grad_()
               for x in _qkv(4, t=33)[:3])
    fa.flash_mha(q, k, v, dropout_p=0.1, seed=1).float().sum().backward()
    assert all(x.grad.dtype == torch.bfloat16 and torch.isfinite(
        x.grad.float()).all() for x in (q, k, v))


# -- the backward's mode and the wrapper ------------------------------------

def test_bwd_mode_follows_the_jax_rule(monkeypatch):
    monkeypatch.delenv("DEEPSENSE_FLASH_BWD", raising=False)
    assert fa.bwd_mode(1024, 128) == "merged"     # the training path
    assert fa.bwd_mode(8192, 128) == "merged"     # exactly 4 MiB
    assert fa.bwd_mode(8704, 128) == "split"
    monkeypatch.setenv("DEEPSENSE_FLASH_BWD", "split")
    assert fa.bwd_mode(1024, 16) == "split"
    monkeypatch.setenv("DEEPSENSE_FLASH_BWD", "bogus")
    with pytest.raises(ValueError, match="DEEPSENSE_FLASH_BWD"):
        fa.bwd_mode(1024, 16)


def test_cpu_backward_never_reaches_a_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "_FNS", {})
    before = dict(_build.KERNEL_LAUNCHES)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(6, t=50)[:3])
    fa.flash_mha(q, k, v, dropout_p=0.1, seed=2).sum().backward()
    assert _build.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("case", ["dropout_p", "do_shape", "lse_dtype"])
def test_backward_input_checks(case):
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(7, t=24, d=32))
    lse = torch.zeros(q.shape[:3])
    if case == "dropout_p":
        with pytest.raises(ValueError, match="dropout_p"):
            fa.flash_mha(q, k, v, dropout_p=1.0, seed=0)
        return
    if case == "do_shape":
        do = do[:, :, :20].contiguous()
    else:
        lse = lse.double()
    with pytest.raises(ValueError, match="backward"):
        fa._check_bwd_inputs(q, k, v, lse, do, q)


# -- the CUDA entries' arguments ---------------------------------------------

_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "uint32_t": ctypes.c_uint32}


def _c_params(library, fname):
    """(type, name) of each parameter of ``extern "C" int fname(...)`` as
    ``csrc/<library>.cu`` declares it."""
    src = (_build.CSRC_DIR / f"{library}.cu").read_text()
    m = re.search(r'extern "C" int ' + fname + r"\((.*?)\)\s*\{", src, re.S)
    assert m, f"{fname} not declared in {library}.cu"
    return [tuple(" ".join(p.split()).rsplit(" ", 1))
            for p in m.group(1).split(",")]


@pytest.mark.parametrize("fname", sorted(fa._SIGNATURES))
def test_ctypes_signature_matches_the_c_entry(fname):
    library, argtypes = fa._SIGNATURES[fname]
    params = _c_params(library, fname)
    assert [_CTYPES[t] for t, _ in params] == list(argtypes)
    assert params[-1] == ("void*", "stream")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["merged", "split"])
def test_cuda_route_packs_each_c_argument(monkeypatch, mode, dtype):
    """flash_mha_bwd's CUDA route with the launch recorded instead of run
    (tensors on the CPU): one C call a backward, each argument as the C
    entry names it, and the kernels it counts (split: the dq and the dk/dv
    kernel of one call, nothing falling back to the plain version)."""
    calls = []
    monkeypatch.setattr(fa, "_device_kind", lambda x: "cuda")
    monkeypatch.setattr(fa, "flash_mha_bwd_reference", None)
    monkeypatch.setattr(
        _build, "launch", lambda library, fname, argtypes, count_as, device,
        *args: calls.append((library, fname, count_as, args)))
    q, k, v, do = (torch.tensor(x, dtype=dtype)
                   for x in _qkv(8, b=2, h=3, t=40, d=32))
    o = torch.tensor(_qkv(9, b=2, h=3, t=40, d=32)[0], dtype=dtype)
    lse = torch.zeros(2, 3, 40)
    dq, dk, dv = fa.flash_mha_bwd(q, k, v, o, lse, do, sm_scale=0.3,
                                  dropout_p=0.1, seed=-7, mode=mode)
    (library, fname, count_as, args), = calls
    assert (library, fname) == (fa.BWD_LIBRARY, f"flash_bwd_{mode}")
    assert count_as == (fa.KERNEL_MERGED if mode == "merged"
                        else (fa.KERNEL_DQ, fa.KERNEL_DKV))
    names = [n for _, n in _c_params(library, fname)]
    assert names[-1] == "stream" and len(args) == len(names) - 1
    got = dict(zip(names, args))
    want = dict(q=q, k=k, v=v, dout=do, o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    assert {n: got[n] for n in want} == {n: x.data_ptr()
                                         for n, x in want.items()}
    assert dq.shape == q.shape and dq.dtype == dtype
    assert got["dvec"] not in {x.data_ptr() for x in want.values()}
    if mode == "merged":     # f32: dq sums in place; bf16: its own buffer
        assert (got["dq_acc"] == dq.data_ptr()) == (dtype == torch.float32)
    assert {n: got[n] for n in ("bh", "t", "d", "is_bf16", "t_pad")} == dict(
        bh=6, t=40, d=32, is_bf16=int(dtype == torch.bfloat16), t_pad=512)
    assert got["sm_scale"] == 0.3 and got["seed"] == (-7) & U32
    assert got["keep_min"] == fa.keep_threshold(0.1)
    assert got["drop_scale"] == fa.drop_scale(0.1)
    assert got["c_in"] == fa._input_scale(0.1, dtype)


@pytest.mark.parametrize("which", [0, 1])
def test_split_kernels_alone_pack_each_c_argument(monkeypatch, which):
    """tools/bench_flash.split_kernels, which times the dq kernel or the
    dk/dv kernel alone: each argument of flash_bwd_dq / flash_bwd_dkv as
    the C entry names it, dvec = rowsum(dO∘O) formed beforehand."""
    from deepsense6g_tii_tpu_torch.tools import bench_flash
    calls = []
    monkeypatch.setattr(
        _build, "launch", lambda library, fname, argtypes, count_as, device,
        *args: calls.append((fname, count_as, args)))
    q, k, v, do = (torch.tensor(x, dtype=torch.bfloat16)
                   for x in _qkv(10, b=1, h=2, t=30, d=16))
    o = torch.tensor(_qkv(11, b=1, h=2, t=30, d=16)[0], dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 30)
    fns = bench_flash.split_kernels(fa, q, k, v, o, lse, do, sm_scale=0.25,
                                    dropout_p=0.1, seed=5)
    out = fns[which]()
    (fname, count_as, args), = calls
    assert (fname, count_as) == (("flash_bwd_dq", fa.KERNEL_DQ),
                                 ("flash_bwd_dkv", fa.KERNEL_DKV))[which]
    names = [n for _, n in _c_params(fa.BWD_LIBRARY, fname)]
    got = dict(zip(names, args))
    outs = dict(dq=out) if which == 0 else dict(dk=out[0], dv=out[1])
    want = dict(q=q, k=k, v=v, dout=do, lse=lse, **outs)
    assert {n: got[n] for n in want} == {n: x.data_ptr()
                                         for n, x in want.items()}
    assert {n: got[n] for n in ("bh", "t", "d", "is_bf16", "t_pad")} == dict(
        bh=2, t=30, d=16, is_bf16=1, t_pad=512)
    assert (got["keep_min"], got["c_in"]) == (
        fa.keep_threshold(0.1), fa._input_scale(0.1, torch.bfloat16))


# -- the integer keep threshold ------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.25, 0.3, 1 / 3, 0.5, 2.0 ** -24, 1e-7,
                               0.9, 1 - 2.0 ** -24])
def test_keep_threshold_equals_the_float_compare(p):
    """The kernels keep an element when its 24-bit draw n is >=
    keep_threshold(p); the plain stream when n·2^-24 >= p in f32.  The two
    agree on all 2^24 draws."""
    n = torch.arange(2 ** 24, dtype=torch.int64)
    u = n.to(torch.float32) * 2.0 ** -24          # as uniform_hash forms it
    thr = fa.keep_threshold(p)
    assert 0 < thr <= 2 ** 24
    assert torch.equal(n >= thr, u >= p)


def test_keep_threshold_is_zero_without_dropout():
    assert fa.keep_threshold(0.0) == 0


# -- bf16 at the production length ---------------------------------------------

T_FULL = 962              # 3 modalities x 5 frames x 8x8 anchors + 2 GPS


def _bf16_qkv(seed, d, n=3):
    """(1, 2, 962, d) inputs rounded to bf16, as numpy f32 and torch bf16."""
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.normal(size=(1, 2, T_FULL, d))
                           .astype(np.float32)).bfloat16() for _ in range(n)]
    return [x.float().numpy() for x in xs], xs


def _bf16_ulps(x, n=2):
    """n bf16 ulps at the largest |x| (8 significant bits)."""
    return n * 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bf16_forward_at_full_length_matches_pallas(d, p):
    """The plain forward that the bf16 kernel is held to on the card,
    against the Pallas kernel (interpret mode) at T = 962, bf16, with the
    default 512 block: within 2 bf16 ulps of the largest |O| (the Pallas
    kernel rounds P to bf16 before P·V, the plain version does not)."""
    (q, k, v), xs = _bf16_qkv(d * 10 + int(p * 10), d)
    key = jax.random.PRNGKey(d)
    sm = d ** -0.5
    want = np.asarray(jfa.flash_mha(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), sm_scale=sm,
        dropout_p=p, rng=key if p else None, interpret=True),
        dtype=np.float32)
    got = fa.flash_mha(*xs, sm_scale=sm, dropout_p=p,
                       seed=_seed(key) if p else None)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, T_FULL, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulps(want))


@pytest.mark.parametrize("mode", ["merged", "split"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bf16_grads_at_full_length_match_pallas(monkeypatch, d, mode):
    """The plain backward that the bf16 kernels (merged and split) are held
    to on the card, against the Pallas kernels' VJP (interpret mode; the
    merged kernel or the dq + dkv pair) at T = 962, bf16, dropout 0.1: each
    gradient within 2 bf16 ulps of its largest value."""
    _jax_bwd_mode(monkeypatch, mode, d)
    (q, k, v, w), xs = _bf16_qkv(d + 7, d, n=4)
    key = jax.random.PRNGKey(5)
    sm = d ** -0.5

    def jax_loss(q, k, v):
        o = jfa.flash_mha(q, k, v, sm_scale=sm, dropout_p=0.1, rng=key,
                          interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    qt, kt, vt = (x.clone().requires_grad_() for x in xs[:3])
    o = fa.flash_mha(qt, kt, vt, sm_scale=sm, dropout_p=0.1, seed=_seed(key))
    (o.float() * xs[3].float()).sum().backward()
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), want, "qkv"):
        ref = np.asarray(ref, dtype=np.float32)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=_bf16_ulps(ref), err_msg=f"d{name}")


def test_dropout_p_must_stay_below_one_in_f32():
    # 1 - 2^-26 < 1, but it rounds to 1.0 in f32: its threshold would be 2^24
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="dropout_p"):
        fa.flash_mha(q, q, q, dropout_p=1 - 2.0 ** -26, seed=0)
    assert fa.keep_threshold(np.nextafter(np.float32(1), np.float32(0))) \
        == 2 ** 24 - 1
