"""Batched greedy serving driver: the continuous-batching scheduler.

Mirrors `repro.launch.serve` (`serve`, `_serve_continuous`, the CLI) for a
dense KV cache in the model dtype at tp=1.  A fixed grid of `batch` slots
shares one (batch x max_len) KV cache; the moment a sequence finishes its
slot is freed and the next pending request (strict FIFO) is admitted at the
next step boundary.  Admission runs one prefill on the fixed grid shape per
distinct prompt length, padding rows included, and grafts the prefilled rows
into the freed slots; decode is one masked step over every slot.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --variant full --requests 8 --batch 4 --prompt-len 128 --gen 32

`quantize="int8"` (`--quantize int8`) packs every projection weight as
block-scaled int8 (`models.layers.quantize_weights`) once, on the device,
before the timed region: decode then streams 1 byte a weight through the
packed bgemv kernel and prefill runs the int8-B bgemm, both dequantizing in
f32 (W8A16, as the reference's pallas backend).

Runs on the card unless asked for the CPU (`device="cpu"`, `--device cpu`),
where every kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import collections
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import steps as steps_lib
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.registry import get_config


def resolve_device(device) -> torch.device:
    """The device to serve on; asking for CUDA without a GPU raises instead
    of carrying on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run the plain versions "
            "on the CPU")
    return dev


def _check_scope(scheduler, quantize, kv_cache, prefill_chunk, kv_page_size,
                 deadline_ms, faults, speculate, tp) -> None:
    """Options of the reference's serve() that this port does not run yet
    raise, naming the ROADMAP §1 item that will port them."""
    if scheduler not in ("continuous", "batch"):
        raise ValueError(f"scheduler must be 'continuous' or 'batch', got {scheduler!r}")
    if quantize not in ("none", "int8"):
        raise ValueError(f"quantize must be 'none' or 'int8', got {quantize!r}")
    if kv_cache not in ("model", "int8"):
        raise ValueError(f"kv_cache must be 'model' or 'int8', got {kv_cache!r}")
    unported = [
        (scheduler == "batch", "scheduler='batch'", 1),
        (kv_cache == "int8", "kv_cache='int8'", 2),
        (kv_page_size is not None, "kv_page_size", 2),
        (prefill_chunk is not None, "prefill_chunk", 3),
        (speculate is not None, "speculate", 3),
        (faults is not None, "faults", 3),
        (deadline_ms is not None, "deadline_ms", 3),
        (tp != 1, "tp > 1", 4),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP §1 item {item})")


def serve(arch: str, variant: str = "smoke", requests: Optional[int] = None,
          batch: int = 4, prompt_len: int = 32, gen: int = 16, seed: int = 0,
          eos: int = 2, verbose: bool = True, scheduler: str = "continuous",
          gen_lens: Optional[Sequence[int]] = None,
          prompts: Optional[Sequence[np.ndarray]] = None,
          quantize: str = "none", kv_cache: str = "model",
          prefill_chunk: Optional[int] = None,
          kv_page_size: Optional[int] = None, deadline_ms=None, faults=None,
          speculate: Optional[int] = None, tp: int = 1,
          params: Optional[dict] = None, device="cuda"):
    """Serve `requests` prompts through greedy decode on `device`.

    Arguments follow the reference's serve(); `params` (the port's layout,
    e.g. from models.convert) replaces the seeded random init, which
    otherwise mirrors the reference's distributions.  quantize="int8" packs
    the projection weights (validated: a NaN/Inf weight raises) before the
    timed region, as the reference's _quantize_params does.  gen_lens gives
    per-request budgets (a budget < 1 still yields the prefill token);
    eos=-1 disables early stopping.

    Returns stats: completed / tokens / prefills / decode_steps counters,
    tok_s, elapsed_s, mean live-slot `occupancy`, per-request `ttft`
    (seconds to the first token), `outputs` (greedy token ids per request,
    in submission order) and per-request admit/finish decode-step indices.
    Kernel builds and first launches run before the timed region.
    """
    cfg = get_config(arch, variant)
    _check_scope(scheduler, quantize, kv_cache, prefill_chunk, kv_page_size,
                 deadline_ms, faults, speculate, tp)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if prompts is not None:
        n = len(prompts)
    elif gen_lens is not None:
        n = len(gen_lens)
    else:
        n = requests if requests is not None else 16
    if requests is not None and requests != n:
        raise ValueError(f"requests={requests} but {n} prompts/gen_lens given")
    if prompts is None:
        prompts = [rng.integers(3, cfg.vocab, size=(prompt_len,), dtype=np.int32)
                   for _ in range(n)]
    prompts = [np.asarray(p, np.int32) for p in prompts]
    gen_lens = [gen] * n if gen_lens is None else list(gen_lens)
    if len(gen_lens) != n:
        raise ValueError(f"{len(gen_lens)} gen_lens for {n} requests")
    with torch.inference_mode():
        if params is None:
            params = tf.init_params(cfg, seed, dev)
        if quantize == "int8":
            params = layers.quantize_weights(params)
        stats = _serve_continuous(cfg, params, prompts, gen_lens, batch, eos, dev)
    if verbose:
        print(f"[serve] {arch} ({scheduler}): {stats['completed']} requests, "
              f"{stats['tokens']} tokens in {stats['elapsed_s']:.2f}s -> "
              f"{stats['tok_s']:.1f} tok/s ({stats['prefills']} prefills, "
              f"{stats['decode_steps']} decode steps, "
              f"occupancy {stats['occupancy']:.2f})", flush=True)
    return stats


def _new_stats(nreq: int) -> dict:
    return {"completed": 0, "tokens": 0, "prefills": 0, "decode_steps": 0,
            "outputs": [[] for _ in range(nreq)], "ttft": [None] * nreq,
            "admit_step": [None] * nreq, "finish_step": [None] * nreq}


def _record_token(stats: dict, rid: int, tok_val: int, eos: int, remaining: int) -> bool:
    """Append one generated token; True if the request just finished (EOS,
    or `remaining` <= 0 tokens of budget left after this one)."""
    stats["outputs"][rid].append(tok_val)
    stats["tokens"] += 1
    if tok_val == eos or remaining <= 0:
        stats["finish_step"][rid] = stats["decode_steps"]
        stats["completed"] += 1
        return True
    return False


def _serve_continuous(cfg, params, prompts, gen_lens, batch, eos, dev) -> dict:
    nreq = len(prompts)
    cache_len = max(len(p) + g for p, g in zip(prompts, gen_lens))
    prefill_fn = steps_lib.make_prefill_step(cfg)
    decode_fn = steps_lib.make_decode_step_slots(cfg)
    # the admission prefill's scalar-pos cache: one buffer reused every
    # round (keys past the prompt are masked by kv_lens, never read)
    mini_buf = tf.init_cache(cfg, batch, cache_len, device=dev)

    def mini():
        return {"k": mini_buf["k"], "v": mini_buf["v"], "pos": 0}

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    # warm-up outside the timed region (kernel build, first launches) on a
    # throwaway slot cache; all-padding slots graft nothing
    warm = tf.init_cache(cfg, batch, cache_len, per_slot=True, device=dev)
    _, warm_mini = prefill_fn(params, zeros((batch, len(prompts[0])), torch.int32), mini())
    tf.insert_slots_cache(warm, warm_mini, np.full(batch, -1))
    warm_tok, _ = decode_fn(params, zeros((batch, 1), torch.int32), warm,
                            zeros(batch, torch.bool))
    warm_tok.cpu()
    del warm, warm_mini, warm_tok

    pending = collections.deque(enumerate(prompts))  # FIFO
    cache = tf.init_cache(cfg, batch, cache_len, per_slot=True, device=dev)
    tok_dev = zeros((batch, 1), torch.int32)
    active = np.zeros(batch, bool)
    active_dev = zeros(batch, torch.bool)
    slot_req = np.full(batch, -1)
    slot_left = np.zeros(batch, np.int64)
    stats = _new_stats(nreq)
    occ = []
    t0 = time.time()
    while pending or active.any():
        # admission: every free slot takes the next pending request
        admits = []
        for s in range(batch):
            if not active[s] and pending:
                rid, prompt = pending.popleft()
                admits.append((s, rid, prompt))
        by_len = {}
        for adm in admits:
            by_len.setdefault(len(adm[2]), []).append(adm)
        for plen in sorted(by_len):
            group = by_len[plen]
            block = np.zeros((batch, plen), np.int32)
            slots = np.full(batch, -1, np.int64)
            for i, (s, _, prompt) in enumerate(group):
                block[i] = prompt
                slots[i] = s
            tok0, filled = prefill_fn(params, torch.from_numpy(block).to(dev), mini())
            stats["prefills"] += 1
            tf.insert_slots_cache(cache, filled, slots)
            g = len(group)
            tok_dev[torch.from_numpy(slots[:g]).to(dev)] = tok0[:g]
            tok0_np = tok0.cpu().numpy()[:, 0]  # sync before stamping TTFT
            t_first = time.time() - t0
            for i, (s, rid, _) in enumerate(group):
                stats["ttft"][rid] = t_first
                stats["admit_step"][rid] = stats["decode_steps"]
                rem = gen_lens[rid] - 1
                if not _record_token(stats, rid, int(tok0_np[i]), eos, rem):
                    active[s] = True
                    slot_req[s] = rid
                    slot_left[s] = rem
            active_dev = torch.from_numpy(active.copy()).to(dev)
        if not active.any():
            continue  # every admitted request finished on its prefill token
        # one masked decode step over the whole slot grid
        stepped = active.copy()
        occ.append(stepped.sum() / batch)
        tok_dev, cache = decode_fn(params, tok_dev, cache, active_dev)
        tok_np = tok_dev.cpu().numpy()[:, 0]
        stats["decode_steps"] += 1
        for s in np.flatnonzero(stepped):
            slot_left[s] -= 1
            if _record_token(stats, slot_req[s], int(tok_np[s]), eos, slot_left[s]):
                active[s] = False
                slot_req[s] = -1
        if not np.array_equal(active, stepped):
            active_dev = torch.from_numpy(active.copy()).to(dev)
    dt = time.time() - t0
    stats["elapsed_s"] = dt
    stats["tok_s"] = stats["tokens"] / dt if dt > 0 else 0.0
    stats["occupancy"] = float(np.mean(occ)) if occ else 0.0
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="continuous", choices=("continuous", "batch"),
                    help="continuous: slot-level admission (batch: not ported yet)")
    ap.add_argument("--quantize", default="none", choices=("none", "int8"),
                    help="int8: block-scaled int8 projection weights (W8A16)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return serve(args.arch, args.variant, args.requests, args.batch,
                 args.prompt_len, args.gen, seed=args.seed,
                 scheduler=args.scheduler, quantize=args.quantize, device=args.device)


if __name__ == "__main__":
    main()
