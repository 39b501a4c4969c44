"""The bf16 flash kernel's design on the CPU: `csrc/flash_attention_bf16.cu`
runs only on the card (`python3 chip_smoke.py` holds it against its plain
version there). What can be held here:

  * its arithmetic, emulated in torch ops: bf16 q and k multiplied exactly
    and summed in fp32, an online softmax over tiles of 128 keys, and p
    split into a bf16 pair p_hi + p_lo before the products with v. Against
    the plain version on the same (bf16-valued) inputs in fp32, and against
    the JAX package's attention oracle, the split stays within 1e-4 x max,
    while rounding p once to bf16 is at least 10x further off: that is why
    the kernel runs two products for p . v;
  * its launch geometry (`flash_attention.bf16_launch`): the grid within
    CUDA's limits from B = 1 to 65,535, the head dim padded to 16, 32, 64 or
    128, 16-byte copies only for D % 8 == 0 on aligned pointers;
  * its source: registered, built without fast math, multiplying with
    bf16 `mma.sync` through `mma_bf16.cuh`, and the fp32 source keeping no
    bf16 entry.

The wrapper's dispatch by dtype to the two C entries is held in
tests/test_torch_flash.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4


def _bf16_qkv(b, sq, h, kv, d, seed, skv=None):
    """bf16 q, k, v from a seeded numpy draw."""
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))]


def emulate_kernel(q, k, v, causal, split=True, tile=FA.BF16_KV_TILE):
    """The bf16 kernel's arithmetic in torch ops, fp32 out (before the
    kernel's bf16 store): scores from the bf16 values in fp32, online
    softmax over `tile` keys, and p rounded to a bf16 pair (hi + lo) or,
    with split=False, once to bf16, before its product with v."""
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, n_kv, h // n_kv, d)
    kf, vf = k.float(), v.float()
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, n_kv, h // n_kv, sq), FA.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, n_kv, h // n_kv, sq, d))
    rows = torch.arange(sq)
    for k0 in range(0, skv, tile):
        kt, vt = kf[:, k0:k0 + tile], vf[:, k0:k0 + tile]
        s = torch.einsum("bskgd,bukd->bkgsu", qf, kt) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1])
            s = torch.where(rows[:, None] >= keys[None, :], s,
                            torch.tensor(FA.NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        hi = p.bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum("bkgsu,bukd->bkgsd", hi, vt)
        if split:
            lo = (p - hi).bfloat16().float()
            acc = acc + torch.einsum("bkgsu,bukd->bkgsd", lo, vt)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,sq,h,kv,d,causal,skv", [
    (1, 1025, 9, 3, 64, True, None),      # smollm-135m's heads, past 1024
    (2, 77, 4, 1, 40, False, None),       # ragged: D % 16 != 0, one kv head
    (1, 130, 6, 2, 24, True, 70),         # Sq != Skv, a partial last tile
])
def test_p_split_carries_p_to_fp32_accuracy(b, sq, h, kv, d, causal, skv):
    """The split within 1e-4 x max of the plain version's fp32 result (the
    same bf16 values widened); one rounding of p at least 10x further."""
    q, k, v = _bf16_qkv(b, sq, h, kv, d, seed=sq + d, skv=skv)
    want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal)
    split = _rel(emulate_kernel(q, k, v, causal), want)
    once = _rel(emulate_kernel(q, k, v, causal, split=False), want)
    assert split <= TOL, split
    assert once >= 10 * split, (once, split)


def test_p_split_matches_the_jax_attention_oracle():
    """The emulation against `repro.kernels.ref.attention_ref` (the JAX
    package's plain attention, fp32 softmax) on the same bf16 values in
    fp32, with the kv heads broadcast for it."""
    q, k, v = _bf16_qkv(1, 200, 4, 2, 32, seed=7)
    got = emulate_kernel(q, k, v, causal=True)
    rep = lambda t: np.repeat(t.float().numpy(), 2, axis=2)  # noqa: E731
    want = jax_ref.attention_ref(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in
          (q.float().numpy(), rep(k), rep(v))), causal=True)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("b,sq,h", [(1, 1, 1), (1, 1984, 9), (2, 2048, 9),
                                    (65535, 64, 9), (1, 100_000, 65535),
                                    (65535, 1, 65535)])
def test_bf16_launch_grid_fits_the_limits(b, sq, h):
    """The grid is (q tiles x heads, batch, 1): every q tile of every head
    of one batch in x, the kernel's longest-first order."""
    plan = FA.bf16_launch(b, sq, h, 64, 0, 0, 0)
    assert plan.grid == (-(-sq // FA.BF16_Q_ROWS) * h, b, 1)
    assert all(g <= lim for g, lim in zip(plan.grid, build.GRID_LIMITS))


@pytest.mark.parametrize("b,sq,h", [(65536, 64, 9),
                                    (1, 2 ** 31 // 2 * 64, 4)])
def test_bf16_launch_raises_past_the_grid_limits(b, sq, h):
    with pytest.raises(ValueError, match="launch grid"):
        FA.bf16_launch(b, sq, h, 64, 0, 0, 0)


def test_bf16_launch_pads_the_head_dim_and_picks_the_copies():
    for d in range(1, FA.MAX_HEAD_DIM + 1):
        plan = FA.bf16_launch(1, 8, 1, d, 0, 0, 0)
        assert plan.d_pad in (16, 32, 64, 128) and plan.d_pad >= d
        assert plan.d_pad // 2 < d or plan.d_pad == 16
        assert plan.vec == (d % 8 == 0)
    assert not FA.bf16_launch(1, 8, 1, 64, 0, 2, 0).vec      # k off 16 bytes
    assert not FA.bf16_launch(1, 8, 1, 64, 0, 0, 32 + 8).vec
    assert FA.bf16_launch(1, 8, 1, 64, 256, 512, 4096).vec


def test_bf16_source_multiplies_on_the_tensor_cores():
    """Registered, built without fast math, bf16 `mma.sync` with fp32
    accumulators through mma_bf16.cuh, two products for the p split, expf
    and no fp32 FMA loop; the block constants are the wrapper's; the fp32
    source keeps no bf16 entry."""
    assert "flash_attention_bf16" in build.SOURCES
    assert "--use_fast_math" not in build.NVCC_FLAGS
    src = (build.CSRC / "flash_attention_bf16.cu").read_text()
    header = (build.CSRC / "mma_bf16.cuh").read_text()
    assert '#include "mma_bf16.cuh"' in src and '#include "epilogue.cuh"' in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert src.count("mma::mma_bf16_16816(") == 6       # S (2), P V hi + lo (4)
    assert "mma::mma_bf16_16816(o[dt], pl," in src
    assert "mma::ldmatrix_x4_trans(" in src and "mma::cp_async16(" in src
    assert "expf(" in src and "__expf(" not in src and "fmaf" not in src
    assert 'extern "C" int flash_attention_bf16(' in src
    assert f"constexpr int kBK = {FA.BF16_KV_TILE};" in src
    assert FA.BF16_Q_ROWS == 16 * 4 and "constexpr int kWarps = 4;" in src
    assert build.library_path("flash_attention_bf16").name.startswith(
        "flash_attention_bf16-")
    fp32 = (build.CSRC / "flash_attention.cu").read_text()
    assert "__nv_bfloat16" not in fp32 and "int bf16" not in fp32
