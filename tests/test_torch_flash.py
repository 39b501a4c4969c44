"""The port's flash attention on the CPU against the JAX package.

  * `kernels.flash_attention.flash_attention_plain`, the plain version of
    the hand-written kernel, against the Pallas kernel in interpret mode
    (`repro.kernels.ops.flash_attention`, which broadcasts the kv heads
    with `jnp.repeat`) at the four cases of tests/test_kernels.py and a
    bf16 one. Lengths keep a large gcd with the Pallas block (512): a prime
    length would make its interpret-mode grid one row a block.
  * `models.flash.flash_attention`, the counterpart of
    `flash_attention_jnp`, on the "torch" backend at the forward cases of
    tests/test_flash.py: five (causal, window, softcap) cases, ragged
    lengths and chunks, the `q_offset` continuation.
  * the kernel wrapper's branches: the plain version on a CPU tensor (fp32
    and bf16), an output allocation on `meta`, its argument checks, no
    backward, the dispatch of a CUDA launch by dtype to the fp32 and the
    bf16 entry (library and stream faked); and the "cuda" backend's
    refusals (window, softcap, q offset).

Tolerance: within 1e-5 x max|reference| in fp32 (both sides sum in fp32,
in other orders); bf16 outputs within one bf16 step of the reference's
(each side rounds its fp32 result to nearest).
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.attention import dense_attention as jax_dense
from repro.models.flash import flash_attention_jnp
from repro_torch import engine as TE
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models import flash as TF
from repro_torch.models.attention import dense_attention

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
KERNEL_CASES = [(2, 64, 4, 2, 16, True), (1, 128, 8, 8, 32, True),
                (2, 96, 4, 4, 16, False), (1, 64, 6, 3, 8, True)]


def _qkv(b, s, h, kv, d, seed=0, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kv,d,causal", KERNEL_CASES)
def test_plain_matches_the_pallas_kernel(b, s, h, kv, d, causal):
    q, k, v = _qkv(b, s, h, kv, d, seed=s + h)
    want = jax_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, interpret=True)
    got = FA.flash_attention_plain(*_t(q, k, v), causal=causal)
    assert got.dtype == torch.float32
    _close(got, want)


def test_plain_matches_the_pallas_kernel_in_bf16():
    """bf16 operands: both widen to fp32, sum in fp32 and round the output
    to bf16, so the two outputs are at most one bf16 step apart."""
    q, k, v = _qkv(2, 64, 4, 2, 16, seed=11)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_ops.flash_attention(qb, kb, vb, causal=True,
                                              interpret=True), np.float32)
    got = FA.flash_attention_plain(*_t(q, k, v, dtype=torch.bfloat16),
                                   causal=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= step).all()


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_the_reference_oracle(causal):
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(2, 40, 3, 3, 8, seed=5))
    want = jax_ref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    _close(ref.attention_ref(*_t(q, k, v), causal=causal), want)


@pytest.mark.parametrize("s,skv", [(37, 37), (20, 70), (70, 20)])
def test_plain_matches_dense_attention_at_ragged_lengths(s, skv):
    """Lengths that are no multiple of the kernel's tiles, and Sq != Skv
    (causal positions from 0 for both q and k)."""
    q, k, v = _t(*_qkv(1, s, 6, 2, 24, seed=s, skv=skv))
    want = dense_attention(q, k, v, causal=True)
    _close(FA.flash_attention_plain(q, k, v, causal=True), want.numpy())


# ---------------------------------------------------------------------------
# models/flash.py against flash_attention_jnp
# ---------------------------------------------------------------------------

def _jnp_flash(q, k, v, **kw):
    return flash_attention_jnp(*map(jnp.asarray, (q, k, v)), **kw)


@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 0, 50.0), (False, 0, 0.0), (True, 16, 0.0),
    (True, 8, 30.0)])
def test_chunked_forward_matches_flash_attention_jnp(causal, window, cap):
    """Also the port's dense attention under the same mask and cap, against
    the reference's."""
    q, k, v = _qkv(2, 64, 4, 2, 16)
    mask = dict(causal=causal, window=window, softcap_val=cap)
    kw = dict(mask, q_chunk=32, kv_chunk=32)
    with TE.using_backend("torch"):
        got = TF.flash_attention(*_t(q, k, v), **kw)
    _close(got, _jnp_flash(q, k, v, **kw))
    want = jax_dense(*map(jnp.asarray, (q, k, v)), **mask)
    _close(dense_attention(*_t(q, k, v), **mask), want)
    _close(got, want)


@pytest.mark.parametrize("s,qc,kc", [(17, 16, 16), (45, 32, 16),
                                     (77, 16, 32), (90, 64, 32)])
def test_chunked_forward_at_ragged_lengths_and_chunks(s, qc, kc):
    q, k, v = _qkv(1, s, 2, 2, 8, seed=s)
    kw = dict(causal=True, q_chunk=qc, kv_chunk=kc)
    with TE.using_backend("ref"):
        got = TF.flash_attention(*_t(q, k, v), **kw)
    _close(got, _jnp_flash(q, k, v, **kw))


def test_chunked_forward_q_offset_continuation():
    """The last 8 queries at q_offset 56 against the full sequence."""
    q, k, v = _qkv(1, 64, 4, 4, 16)
    kw = dict(causal=True, q_offset=56, q_chunk=8, kv_chunk=16)
    with TE.using_backend("torch"):
        got = TF.flash_attention(*_t(q[:, 56:], k, v), **kw)
    full = dense_attention(*_t(q, k, v), causal=True)
    part = dense_attention(*_t(q[:, 56:], k, v), causal=True, q_offset=56)
    _close(got, _jnp_flash(q[:, 56:], k, v, **kw))
    _close(got, full[:, 56:].numpy())
    _close(part, jax_dense(*map(jnp.asarray, (q[:, 56:], k, v)), causal=True,
                           q_offset=56))


def test_chunked_forward_keeps_bf16_io():
    q, k, v = _qkv(1, 32, 2, 1, 8)
    with TE.using_backend("torch"):
        got = TF.flash_attention(*_t(q, k, v, dtype=torch.bfloat16),
                                 causal=True, q_chunk=16, kv_chunk=16)
    want = _jnp_flash(*(jnp.asarray(a).astype(jnp.bfloat16)
                        for a in (q, k, v)), causal=True, q_chunk=16,
                      kv_chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("causal", [True, False])
def test_cuda_backend_runs_the_kernel_wrapper(causal):
    """On "cuda" global attention is one call of the kernel wrapper, whose
    CPU branch is the plain version (no launch is counted)."""
    q, k, v = _qkv(2, 96, 6, 2, 16, seed=3)
    before = FA.flash_attention.launches
    with TE.using_backend("cuda"):
        got = TF.flash_attention(*_t(q, k, v), causal=causal)
    assert FA.flash_attention.launches == before
    assert torch.equal(got, FA.flash_attention_plain(*_t(q, k, v),
                                                     causal=causal))
    _close(got, _jnp_flash(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_cuda_backend_runs_the_kernel_wrapper_on_bf16(causal):
    """bf16 q, k, v on "cuda": one call of the wrapper, whose CPU branch is
    the plain version; neither kernel's launch is counted."""
    q, k, v = _t(*_qkv(2, 96, 6, 2, 16, seed=4), dtype=torch.bfloat16)
    before = (FA.flash_attention.launches, FA.flash_attention_bf16.launches)
    with TE.using_backend("cuda"):
        got = TF.flash_attention(q, k, v, causal=causal)
    assert (FA.flash_attention.launches,
            FA.flash_attention_bf16.launches) == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, FA.flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("kw", [dict(window=16), dict(softcap_val=30.0),
                                dict(q_offset=8)])
def test_cuda_backend_refuses_what_the_kernel_lacks(kw):
    q, k, v = _t(*_qkv(1, 32, 2, 1, 8))
    with TE.using_backend("cuda"), \
            pytest.raises(NotImplementedError, match="queue 1, item 8"):
        TF.flash_attention(q, k, v, causal=True, **kw)


# ---------------------------------------------------------------------------
# the kernel wrapper's branches
# ---------------------------------------------------------------------------

def test_wrapper_on_meta_allocates_only():
    before = FA.flash_attention.launches
    q = torch.empty((1, 1984, 9, 64), device="meta")
    k = torch.empty((1, 1984, 3, 64), device="meta")
    out = ops.flash_attention(q, k, k, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == torch.float32
    assert FA.flash_attention.launches == before


def test_ops_makes_operands_contiguous():
    q, k, v = _t(*_qkv(1, 24, 4, 2, 8, seed=9))
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)   # strided view
    assert not qt.is_contiguous()
    assert torch.equal(ops.flash_attention(qt, k, v),
                       FA.flash_attention_plain(q, k, v))
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(qt, k, v)


@pytest.mark.parametrize("shapes,dtypes,err,match", [
    (((1, 8, 4, 8), (1, 8, 3, 8), (1, 8, 3, 8)), None, ValueError,
     "multiple"),
    (((1, 8, 4, 8), (1, 8, 2, 8), (1, 9, 2, 8)), None, ValueError,
     "takes q"),
    (((1, 8, 4, 8), (2, 8, 2, 8), (2, 8, 2, 8)), None, ValueError,
     "takes q"),
    (((1, 8, 2, 8), (1, 8, 2, 4), (1, 8, 2, 4)), None, ValueError,
     "takes q"),
    (((8, 4, 8), (8, 2, 8), (8, 2, 8)), None, ValueError, "takes q"),
    (((1, 8, 2, 130), (1, 8, 2, 130), (1, 8, 2, 130)), None, ValueError,
     "head dim"),
    (((1, 8, 2, 8), (1, 0, 2, 8), (1, 0, 2, 8)), None, ValueError,
     "one key"),
    (((1, 8, 2, 8),) * 3, (torch.float16,) * 3, TypeError, "fp32 or bf16"),
    (((1, 8, 2, 8),) * 3, (torch.float32, torch.bfloat16, torch.float32),
     TypeError, "k must be"),
])
def test_wrapper_checks_its_operands(shapes, dtypes, err, match):
    dtypes = dtypes or (torch.float32,) * 3
    q, k, v = (torch.zeros(s, dtype=dt) for s, dt in zip(shapes, dtypes))
    with pytest.raises(err, match=match):
        FA.flash_attention(q, k, v)


@pytest.mark.parametrize("shapes,dtypes,err,match", [
    (((1, 8, 4, 8), (1, 8, 3, 8), (1, 8, 3, 8)), None, ValueError,
     "multiple"),
    (((1, 8, 2, 130),) * 3, None, ValueError, "head dim"),
    (((1, 8, 2, 8),) * 3, (torch.bfloat16, torch.float32, torch.bfloat16),
     TypeError, "k must be"),
    (((1, 8, 2, 8),) * 3, (torch.bfloat16, torch.bfloat16, torch.float16),
     TypeError, "v must be"),
])
def test_wrapper_checks_its_bf16_operands(shapes, dtypes, err, match):
    dtypes = dtypes or (torch.bfloat16,) * 3
    q, k, v = (torch.zeros(s, dtype=dt) for s, dt in zip(shapes, dtypes))
    with pytest.raises(err, match=match):
        FA.flash_attention(q, k, v)


def test_wrapper_on_meta_keeps_bf16():
    q = torch.empty((1, 1984, 9, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 1984, 3, 64), device="meta", dtype=torch.bfloat16)
    before = FA.flash_attention_bf16.launches
    out = ops.flash_attention(q, k, k, causal=True)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert FA.flash_attention_bf16.launches == before


@pytest.mark.parametrize("which", [0, 1, 2])
def test_no_backward_yet(which):
    qkv = _t(*_qkv(1, 16, 2, 1, 8))
    qkv[which].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 13"):
        FA.flash_attention(*qkv)


def test_source_is_registered_and_built_without_fast_math():
    """The kernel is one of the sources `build_all` compiles, with the
    accurate expf and no fast-math flag."""
    assert "flash_attention" in build.SOURCES
    assert "--use_fast_math" not in build.NVCC_FLAGS
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert "expf(" in src and "__expf(" not in src
    assert 'extern "C" int flash_attention(' in src
    assert build.library_path("flash_attention").name.startswith(
        "flash_attention-")


@pytest.mark.parametrize("dtype,entry", [(torch.float32, "flash_attention"),
                                         (torch.bfloat16,
                                          "flash_attention_bf16")])
def test_wrapper_dispatches_by_dtype(monkeypatch, dtype, entry):
    """The CUDA branch of the wrapper (run here on CPU tensors with the
    library and the stream faked) calls the entry of q's dtype with the C
    signature's arguments (the copy flag from that entry's plan) and counts
    that entry's launch alone: a non-causal launch (a cross layer's) once
    more on that entry's non-causal counter, a causal one not."""
    calls = []

    def fake_library(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return types.SimpleNamespace(**{name: fn})

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(FA, "_launcher", FA._launcher.__wrapped__)
    monkeypatch.setattr(FA, "_launcher_bf16", FA._launcher_bf16.__wrapped__)
    monkeypatch.setattr(torch.cuda, "device", lambda _: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    q, k, v = (t.to(dtype) for t in _t(*_qkv(2, 33, 6, 2, 40, seed=1)))
    out = torch.empty_like(q)
    counters = (FA.flash_attention, FA.flash_attention_bf16,
                FA.flash_attention_noncausal, FA.flash_attention_bf16_noncausal)
    before = tuple(c.launches for c in counters)
    FA._launch(q, k, v, out, False, None)
    assert [name for name, _ in calls] == [entry]
    args = calls[0][1]
    want = FA.BF16_ARGTYPES if dtype == torch.bfloat16 else FA.ARGTYPES
    assert len(args) == len(want)
    assert args[4:10] == (2, 33, 33, 6, 2, 40)
    assert args[10] == pytest.approx(1 / math.sqrt(40)) and args[11] == 0
    plan = FA.bf16_launch if dtype == torch.bfloat16 else FA.f32_launch
    assert args[12] == int(plan(2, 33, 6, 40, *args[:3]).vec)
    bumped = (1, 0) if dtype == torch.float32 else (0, 1)
    after = tuple(c.launches for c in counters)
    assert tuple(a - b for a, b in zip(after, before)) == bumped * 2
    FA._launch(q, k, v, out, True, None)
    assert calls[1][1][11] == 1
    again = tuple(c.launches for c in counters)
    assert tuple(a - b for a, b in zip(again, after)) == bumped + (0, 0)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
