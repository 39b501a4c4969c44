"""Serving programs, and the dense-cache greedy baseline. A copy of the
JAX package's `serve/engine.py`, the parts this port runs: the
re-batchable `prefill_program` and `decode_program` over a dense decode
state (the static `Scheduler`'s programs), `paged_decode_program` and
`prefill_ingest_program` over the paged KV pool (the
`ContinuousScheduler`'s, each with its numerics-guard variant),
`decode_state_shapes` and `greedy_generate`. The mesh-sharded `build_serve_step`/`build_prefill` are
not ported (ROADMAP queue 1, item 11).

The programs are captured on `meta` tensors (`engine.trace_program`) and
record every executed engine op: unlike the reference's scanned layers,
whose trace records one layer group, a full-depth smollm-135m decode
program records 2 gathers, 30 x 7 GEMMs and the unembedding, and an
xlstm-125m one 67 GEMMs and no gather (its prefill adds 12 depthwise
convs), and a llama-3.2-vision-11b one 32 x 7 + 8 x 5 + 1 GEMMs (a cross
layer reads its image cache: no wk, wv).
A VLM's batch carries `image_embeds` beside its tokens: `greedy_generate`
and `T.prefill` take it, `decode_state_shapes` holds the image caches.
`prefill_program` takes tokens alone, as the reference's does;
`launch/serve.py` traces the VLM's prefill over both.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import engine as E
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def decode_state_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """The dense decode state of `batch` rows and `max_len` slots as
    `meta` tensors (`T.init_decode_state`'s tree and dtypes)."""
    return T.init_decode_state(cfg, batch, max_len, device="meta")


def prefill_program(cfg: ModelConfig, batch: int, seq: int,
                    max_len: Optional[int] = None, logits_only: bool = False,
                    param_dtype: Optional[torch.dtype] = None) -> E.Program:
    """The serving prefill forward as a re-batchable `engine.Program`:
    (params, {"tokens": (B, seq) int32}) -> (last-token logits (B, V),
    dense decode state of `max_len` slots, default `seq`).

    `logits_only=True` drops the decode state (a scoring service: tokens
    in, last-token logits out), the request shape the static `Scheduler`
    packs into batches. The parameters' `meta` stand-ins take
    `T.param_dtype(cfg, param_dtype)`."""
    max_len = seq if max_len is None else max_len
    params_sh = T.param_shapes(cfg, param_dtype)

    def batch_sh(b):
        return {"tokens": torch.empty((b, seq), dtype=torch.int32,
                                      device="meta")}

    if logits_only:
        def fn(params, batch_in):
            return T.prefill(cfg, params, batch_in, max_len)[0]
    else:
        def fn(params, batch_in):
            return T.prefill(cfg, params, batch_in, max_len)

    axes = E.infer_batch_axes((params_sh, batch_sh(batch)),
                              (params_sh, batch_sh(batch + 1)))
    # the two variants return different outputs: keep their names apart
    # (a Program's equality and hash are its name and ops)
    suffix = "-logits" if logits_only else ""
    return E.trace_program(fn, params_sh, batch_sh(batch),
                           name=f"{cfg.name}-prefill{seq}{suffix}",
                           batch_size=batch, batch_axes=axes)


def decode_program(cfg: ModelConfig, batch: int, max_len: int,
                   param_dtype: Optional[torch.dtype] = None) -> E.Program:
    """One greedy decode step (one token against a dense `max_len`-slot
    cache) as a re-batchable `engine.Program`: (params, state, tokens
    (B, 1) int32, pos () int32) -> logits (B, 1, V). The step writes its
    key and value into `state` in place (the scheduler gives it a packed
    copy). `param_dtype` as for `prefill_program`."""
    params_sh = T.param_shapes(cfg, param_dtype)
    pos_sh = torch.empty((), dtype=torch.int32, device="meta")

    def avals(b):
        return (params_sh, decode_state_shapes(cfg, b, max_len),
                torch.empty((b, 1), dtype=torch.int32, device="meta"),
                pos_sh)

    def fn(params, state, tok, pos):
        return T.decode_step(cfg, params, state, tok, pos)[0]

    axes = E.infer_batch_axes(avals(batch), avals(batch + 1))
    return E.trace_program(fn, *avals(batch),
                           name=f"{cfg.name}-decode{max_len}",
                           batch_size=batch, batch_axes=axes)


def _poisoned(logits: torch.Tensor, poison: torch.Tensor) -> torch.Tensor:
    """The numerics guard's poison: NaN where `poison` is NaN, the logits
    selected bit for bit elsewhere (`torch.where` copies them, signed zeros
    included)."""
    return torch.where(torch.isnan(poison), float("nan"), logits)


def paged_decode_program(cfg: ModelConfig, layout, batch: int,
                         param_dtype: Optional[torch.dtype] = None,
                         guard: bool = False) -> E.Program:
    """One continuous-batching decode step over a paged KV pool, as an
    `engine.Program`.

    Signature of the traced fn:
        (params, pool_arrays, tables (B, blocks_per_req) int32,
         slots (B,) int32, tokens (B, 1) int32, pos (B,) int32)
        -> (next_token (B,) int64, pool_arrays)

    Each step gathers every row's dense state from its blocks
    (`engine.paged_gather`, recorded ops, so the program's `NetworkPlan`
    prices the rebuild), runs the unchanged `T.decode_step` at per-row
    positions, and writes back, in place, only the slot each row wrote.
    `layout` is a `serve.kv_pool.PagedLayout`; the parameters' `meta`
    stand-ins take `T.param_dtype(cfg, param_dtype)`, the dtype of the
    parameters the program will run on.

    `guard=True` builds the numerics-guard variant that a fault-injecting
    `ContinuousScheduler` compiles: a trailing `poison (B,) fp32` argument
    (0.0 clean, NaN to poison a row) and an `ok (B,) bool` output before
    the pool (each row's last-token logits all finite). The poison reaches
    the logits only, through `torch.where` after the step, so a clean row
    keeps its logits bit for bit, and the pool is always written with the
    step's own finite state. The engine ops are the unguarded program's,
    and the pool write is the last op of both: a fault in any engine op
    leaves the pool as it was."""
    npb = layout.blocks_per_req

    def fn(params, arrays, tables, slots, tokens, pos, poison=None):
        state = layout.gather(arrays, tables, slots)
        logits, new_state = T.decode_step(cfg, params, state, tokens, pos)
        out = layout.scatter_step(arrays, new_state, tables, slots, pos)
        if poison is None:
            return torch.argmax(logits[:, -1], dim=-1), out
        last = _poisoned(logits[:, -1], poison[:, None])
        return (torch.argmax(last, dim=-1), torch.isfinite(last).all(-1),
                out)

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    avals = (T.param_shapes(cfg, param_dtype), layout.array_avals(),
             meta(batch, npb),
             meta(batch), meta(batch, 1), meta(batch))
    if guard:
        avals += (meta(batch, dtype=torch.float32),)
    return E.trace_program(
        fn, *avals,
        name=f"{cfg.name}-paged-decode{layout.max_len}"
             f"x{layout.block_size}b{batch}{'-guard' if guard else ''}")


def prefill_ingest_program(cfg: ModelConfig, layout, seq: int,
                           param_dtype: Optional[torch.dtype] = None,
                           guard: bool = False) -> E.Program:
    """Prefill one request at its exact prompt length and ingest the
    resulting dense state into the paged pool, in place (the continuous
    scheduler's admission path; compiled per distinct prompt length, so a
    request's prefill never depends on its batchmates).

    Signature: (params, pool_arrays, table_row (blocks_per_req,) int32,
    slot () int32, tokens (1, seq) int32) -> (first_token (1,) int64,
    pool_arrays). `param_dtype` as for `paged_decode_program`; `guard=True`
    is its numerics-guard variant: a trailing `poison () fp32` and an
    `ok () bool` output, the poison on the logits only, never on the
    ingested state."""
    n_blocks = -(-seq // layout.block_size)

    def fn(params, arrays, table_row, slot, tokens, poison=None):
        logits, state = T.prefill(cfg, params, {"tokens": tokens},
                                  layout.max_len)
        out = layout.scatter_prefill(arrays, state, table_row, slot,
                                     n_blocks)
        if poison is None:
            return torch.argmax(logits, dim=-1), out
        logits = _poisoned(logits, poison)
        return (torch.argmax(logits, dim=-1), torch.isfinite(logits).all(),
                out)

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    avals = (T.param_shapes(cfg, param_dtype), layout.array_avals(),
             meta(layout.blocks_per_req), meta(), meta(1, seq))
    if guard:
        avals += (meta(dtype=torch.float32),)
    return E.trace_program(
        fn, *avals,
        name=f"{cfg.name}-prefill-ingest{seq}{'-guard' if guard else ''}")


def greedy_generate(cfg: ModelConfig, params, batch_in: Dict, steps: int,
                    max_len: int) -> torch.Tensor:
    """Prefill then greedily decode `steps` tokens on a dense cache (the
    baseline the paged path is held against), on the device of
    `batch_in["tokens"]`, under the ambient `EngineConfig` (wrap the call
    in `engine.tracking()` to collect the MMIE-projected cost of every op).
    `batch_in` holds "tokens" (B, S) and, for a VLM, "image_embeds"; the
    decode starts at position S, as the reference's does. Returns (B,
    steps) int64."""
    with torch.no_grad():
        logits, state = T.prefill(cfg, params, batch_in, max_len)
        pos0 = batch_in["tokens"].shape[1]
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = [tok]
        for i in range(steps - 1):
            logits_i, state = T.decode_step(cfg, params, state, tok,
                                            pos0 + i)
            tok = torch.argmax(logits_i[:, -1], dim=-1)[:, None]
            out.append(tok)
    return torch.cat(out, dim=1)
