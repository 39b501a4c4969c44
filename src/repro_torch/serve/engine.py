"""Serving programs over the paged KV pool, and the dense-cache greedy
baseline. A copy of the JAX package's `serve/engine.py`, the parts this
port runs: `paged_decode_program`, `prefill_ingest_program` (both without
the reference's numerics-guard variant, ROADMAP queue 1, item 9) and
`greedy_generate`. The mesh-sharded `build_serve_step`/`build_prefill` and
the re-batchable `prefill_program`/`decode_program` are not ported
(ROADMAP queue 1, items 2 and 11).

The programs are captured on `meta` tensors (`engine.trace_program`) and
record every executed engine op: unlike the reference's scanned layers,
whose trace records one layer group, a full-depth smollm-135m decode
program records 2 gathers, 30 x 7 GEMMs and the unembedding, and an
xlstm-125m one 67 GEMMs and no gather (its prefill adds 12 depthwise
convs).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import engine as E
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def paged_decode_program(cfg: ModelConfig, layout, batch: int,
                         param_dtype: Optional[torch.dtype] = None
                         ) -> E.Program:
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
    parameters the program will run on."""
    npb = layout.blocks_per_req

    def fn(params, arrays, tables, slots, tokens, pos):
        state = layout.gather(arrays, tables, slots)
        logits, new_state = T.decode_step(cfg, params, state, tokens, pos)
        out = layout.scatter_step(arrays, new_state, tables, slots, pos)
        return torch.argmax(logits[:, -1], dim=-1), out

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    avals = (T.param_shapes(cfg, param_dtype), layout.array_avals(),
             meta(batch, npb),
             meta(batch), meta(batch, 1), meta(batch))
    return E.trace_program(
        fn, *avals,
        name=f"{cfg.name}-paged-decode{layout.max_len}"
             f"x{layout.block_size}b{batch}")


def prefill_ingest_program(cfg: ModelConfig, layout, seq: int,
                           param_dtype: Optional[torch.dtype] = None
                           ) -> E.Program:
    """Prefill one request at its exact prompt length and ingest the
    resulting dense state into the paged pool, in place (the continuous
    scheduler's admission path; compiled per distinct prompt length, so a
    request's prefill never depends on its batchmates).

    Signature: (params, pool_arrays, table_row (blocks_per_req,) int32,
    slot () int32, tokens (1, seq) int32) -> (first_token (1,) int64,
    pool_arrays). `param_dtype` as for `paged_decode_program`."""
    n_blocks = -(-seq // layout.block_size)

    def fn(params, arrays, table_row, slot, tokens):
        logits, state = T.prefill(cfg, params, {"tokens": tokens},
                                  layout.max_len)
        out = layout.scatter_prefill(arrays, state, table_row, slot,
                                     n_blocks)
        return torch.argmax(logits, dim=-1), out

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    avals = (T.param_shapes(cfg, param_dtype), layout.array_avals(),
             meta(layout.blocks_per_req), meta(), meta(1, seq))
    return E.trace_program(fn, *avals,
                           name=f"{cfg.name}-prefill-ingest{seq}")


def greedy_generate(cfg: ModelConfig, params, batch_in: Dict, steps: int,
                    max_len: int) -> torch.Tensor:
    """Prefill then greedily decode `steps` tokens on a dense cache (the
    baseline the paged path is held against), on the device of
    `batch_in["tokens"]`, under the ambient `EngineConfig` (wrap the call
    in `engine.tracking()` to collect the MMIE-projected cost of every op).
    Returns (B, steps) int64."""
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
