"""Serving entry point: batched prefill + greedy decode with the grouped state.
A copy of the JAX package's `launch/serve.py`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --reduced --batch 4 --prompt-len 64 --gen 32 --device cpu

Parameters come from `--seed` (`T.init_params`, drawn on the serving
device); the tokens and, for a VLM, the image embeddings (normal x 0.1 in
bf16, as the reference draws them) from explicit `torch.Generator`s seeded
with it. The reference jits its prefill and its decode step; here each is
an `engine.compile` of a `trace_program` over the same arguments (tokens
and image embeddings; state, token and position), run under the "cuda"
backend: the hand-written kernels on a GPU, their plain versions on CPU
tensors (`--device cpu`).
`--device` defaults to the GPU and raises where there is none.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch import engine as E
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """The inputs `main` serves: int32 tokens (B, S) uniform over the vocabulary
    and, for a VLM, bf16 `image_embeds` (B, n_img_tokens, d_model), each
    from a `torch.Generator` seeded with `seed`, drawn on the host."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32)
    out = {"tokens": tokens.to(device)}
    if cfg.n_img_tokens:
        img = torch.randn((batch, cfg.n_img_tokens, cfg.d_model),
                          generator=torch.Generator().manual_seed(seed))
        out["image_embeds"] = (img.to(torch.bfloat16) * 0.1).to(device)
    return out


def prefill_program(cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    max_len: int, param_dtype: torch.dtype) -> E.Program:
    """`T.prefill` over `batch`'s shapes (tokens, and image embeddings for
    a VLM) as an `engine.Program`: (params, batch) -> (last-token logits
    (B, V), dense decode state of `max_len` slots)."""
    batch_sh = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in batch.items()}

    def fn(params, batch_in):
        return T.prefill(cfg, params, batch_in, max_len)

    b, s = batch["tokens"].shape
    return E.trace_program(fn, T.param_shapes(cfg, param_dtype), batch_sh,
                           name=f"{cfg.name}-serve-prefill{s}b{b}")


def generate(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
             steps: int, config: Optional[E.EngineConfig] = None,
             record: Optional[List[torch.Tensor]] = None):
    """Compile the prefill and decode programs under `config` (default
    `EngineConfig(backend="cuda")`), prefill `batch` and greedily decode
    `steps` tokens. Returns (tokens (B, steps) int64, prefill seconds,
    decode seconds). `record`, when given, receives each step's fp32
    logits (B, V), the prefill's first."""
    config = config if config is not None else E.EngineConfig(backend="cuda")
    b, s = batch["tokens"].shape
    max_len = s + steps + 8
    dtype = params["embed"].dtype
    dev = batch["tokens"].device
    prefill = E.compile(prefill_program(cfg, batch, max_len, dtype), config)
    decode = E.compile(SE.decode_program(cfg, b, max_len, param_dtype=dtype),
                       config)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, state = prefill.apply(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0
    if record is not None:
        record.append(logits.float())
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(steps - 1):
        pos = torch.tensor(s + i, dtype=torch.int32, device=dev)
        logits_i = decode.apply(params, state, tok.to(torch.int32), pos)
        if record is not None:
            record.append(logits_i[:, -1].float())
        tok = torch.argmax(logits_i[:, -1], dim=-1)[:, None]
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), t_prefill, t_decode


def main(argv=None) -> torch.Tensor:
    """Parse `argv` (the reference's flags and `--device`), serve one batch
    and print what the reference prints. Returns the generated tokens
    (B, gen) int64."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name}: an encoder-only arch has no decode path")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the port's plain CPU path explicitly")
    params = T.init_params(cfg, seed=args.seed, device=dev)
    b, s = args.batch, args.prompt_len
    batch = make_batch(cfg, b, s, args.seed, dev)
    gen, t_prefill, t_decode = generate(cfg, params, batch, args.gen)

    print(f"arch={cfg.name} batch={b} prompt={s} gen={args.gen}")
    print(f"prefill: {t_prefill*1e3:.0f} ms "
          f"({b*s/max(t_prefill,1e-9):.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.0f} ms "
          f"({b*(args.gen-1)/max(t_decode,1e-9):.1f} tok/s)")
    print("sample generations:")
    for row in gen[:2]:
        print("  ", row.tolist()[:24])
    return gen


if __name__ == "__main__":
    main()
