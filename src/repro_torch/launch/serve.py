"""Batched greedy serving: the continuous and the batch scheduler.

Mirrors `repro.launch.serve` (`serve`, `_serve_continuous`, `_serve_batch`,
the CLI) at tp=1.  Continuous (`--scheduler continuous`, the default): a
fixed grid of `batch` slots shares one KV cache; the moment a sequence
finishes its slot is freed and the next pending request (strict FIFO) is
admitted at the next step boundary.  Admission runs one prefill on the
fixed grid shape per distinct prompt length, padding rows included, and
grafts the prefilled rows into the freed slots; decode is one masked step
over every slot.

Batch (`--scheduler batch`): requests of one prompt length are served in
FIFO groups of `batch`; each group runs one (batch, T) prefill, padding
rows included, and decodes in lockstep until every member has finished.
It is the only scheduler of the rwkv and hybrid (zamba2) families, whose
caches hold recurrent state with no per-slot form, and of the audio family
(whisper), whose cache keeps one position for the batch.

The vlm family (paligemma) prefills seeded random patch embeddings (B,
n_prefix, d) in front of every prompt, and the audio family random frame
embeddings (B, n_frames, d) for its encoder: the stub frontends, drawn, as
the reference draws them, from numpy's generator seeded with seed + 1, one
(batch, ...) block a prefill (warm-up included).  A vlm prompt takes
n_prefix more cache positions, and is never matched against another's
pages (equal tokens behind other patches are other keys).  So a preempted
vlm request is recomputed behind new patches and is not bit for bit its
first run (the reference's caveat, serve.py:124-125).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --variant full --requests 8 --batch 4 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --scheduler batch --variant full --requests 8 --batch 4 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
        --variant full --requests 8 --batch 4 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --variant full --requests 8 --batch 4 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \
        --scheduler batch --variant full --requests 8 --batch 4 --prompt-len 128 --gen 32

`quantize="int8"` (`--quantize int8`) packs every projection weight as
block-scaled int8 (`models.layers.quantize_weights`) once, on the device,
before the timed region: decode then streams 1 byte a weight through the
packed bgemv kernel and prefill runs the int8-B bgemm, both dequantizing in
f32 (W8A16, as the reference's pallas backend).  The hybrid family refuses
it: the reference crashes there (its shared block's LoRA merge adds to a
packed wq; ROADMAP §3), and the port serves nothing the reference cannot.

`kv_cache="int8"` (`--kv-cache int8`) stores K and V as int8 with one f32
scale per (token, head) (`core.quant.quantize_kv`), the admission prefill's
cache included, and attention dequantizes them in-kernel.

`kv_page_size=P` (`--kv-page-size P`) stores the cache PAGED: a pool of
P-token pages and a (batch, max_pages) page table, with the reference's
admission policy (`launch/paging.py` keeps the books on the host).  A prompt
is hashed page by page against the prompts admitted before it
(`prefix_reuse`, `--prefix-reuse on|off`): a matched prefix is backed by
the same physical pages, only the unshared suffix is grafted into the pool,
and the first write into a shared page copies it.  Slots grow their page
run on demand; admission blocks at the allocator's watermark, a failed
growth preempts the newest admission, whose request is re-queued and
recomputed bit for bit from prompt + emitted tokens, and a request no pool
could hold is "rejected".  `pool_pages` (`--pool-pages`) shrinks the pool
to make that happen.  Every paged serve ends with the allocator's leak
check.  Under the batch scheduler a paged group takes fresh pages per
member (prompt + first decode write), grows them on demand, and a failed
growth preempts the group's newest live member, which is re-served from
its original prompt in a later group (a full recompute); each group drain
runs the leak check.

Runs on the card unless asked for the CPU (`device="cpu"`, `--device cpu`),
where every kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import paging
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


def _check_scope(cfg, scheduler, quantize, kv_cache, prefill_chunk, kv_page_size,
                 pool_pages, deadline_ms, faults, speculate, check_invariants, tp) -> None:
    """Validate the options with the reference's ValueErrors, in its order;
    then those of the reference's serve() that this port does not run yet
    raise NotImplementedError, naming the ROADMAP §1 item that will port
    them."""
    if scheduler not in ("continuous", "batch"):
        raise ValueError(f"scheduler must be 'continuous' or 'batch', got {scheduler!r}")
    if quantize not in ("none", "int8"):
        raise ValueError(f"quantize must be 'none' or 'int8', got {quantize!r}")
    if kv_cache not in ("model", "int8"):
        raise ValueError(f"kv_cache must be 'model' or 'int8', got {kv_cache!r}")
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    if prefill_chunk is not None and scheduler != "continuous":
        raise ValueError("prefill_chunk interleaves admission chunks with "
                         "decode steps and needs --scheduler continuous")
    slot_families = tf.SLOT_CACHE_FAMILIES
    if speculate is not None:
        if speculate < 1:
            raise ValueError(f"speculate needs >= 1 draft tokens, got {speculate}")
        if cfg.family not in slot_families:
            raise ValueError(
                f"speculative decoding rewinds per-slot KV positions and "
                f"supports {slot_families} families; {cfg.family!r} "
                f"has recurrent state that cannot roll back")
    if kv_page_size is not None:
        if kv_page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1, got {kv_page_size}")
        if cfg.family not in slot_families:
            raise ValueError(
                f"paged KV cache supports {slot_families} families "
                f"(per-slot KV caches); {cfg.family!r} keeps the dense cache")
    if pool_pages is not None:
        if kv_page_size is None:
            raise ValueError("pool_pages sizes the paged pool and needs kv_page_size")
        if pool_pages < 2:
            raise ValueError(f"pool_pages needs >= 2 (trash + 1 allocatable), got {pool_pages}")
    if scheduler == "continuous" and cfg.family not in slot_families:
        raise ValueError(
            f"continuous scheduler supports {slot_families} "
            f"families (per-slot KV caches); {cfg.family!r} needs "
            f"--scheduler batch")
    if quantize == "int8" and cfg.family == "hybrid":
        raise ValueError(
            "quantize='int8' is not supported for the hybrid family: the shared "
            "attention block's LoRA merge adds an f32 delta to a packed wq, where the "
            "reference raises AttributeError (ROADMAP §3)")
    unported = [
        (prefill_chunk is not None, "prefill_chunk", "serving options"),
        (speculate is not None, "speculate", "serving options"),
        (faults is not None, "faults", "serving options"),
        (deadline_ms is not None, "deadline_ms", "serving options"),
        (check_invariants, "check_invariants", "serving options"),
        (tp != 1, "tp > 1", "tensor parallelism"),
    ]
    for hit, what, label in unported:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP §1: {label})")


def serve(arch: str, variant: str = "smoke", requests: Optional[int] = None,
          batch: int = 4, prompt_len: int = 32, gen: int = 16, seed: int = 0,
          eos: int = 2, verbose: bool = True, scheduler: str = "continuous",
          gen_lens: Optional[Sequence[int]] = None,
          prompts: Optional[Sequence[np.ndarray]] = None,
          quantize: str = "none", kv_cache: str = "model",
          prefill_chunk: Optional[int] = None,
          kv_page_size: Optional[int] = None, prefix_reuse: bool = True,
          deadline_ms=None, pool_pages: Optional[int] = None,
          check_invariants: bool = False, faults=None,
          speculate: Optional[int] = None, tp: int = 1,
          params: Optional[dict] = None, device="cuda"):
    """Serve `requests` prompts through greedy decode on `device`.

    Arguments follow the reference's serve(); `params` (the port's layout,
    e.g. from models.convert) replaces the seeded random init, which
    otherwise mirrors the reference's distributions.  quantize="int8" packs
    the projection weights (validated: a NaN/Inf weight raises) before the
    timed region, as the reference's _quantize_params does.
    kv_cache="int8" stores the KV cache as int8 with one f32 scale per
    (token, head), written in lockstep and read by the int8 attention body.
    kv_page_size stores it paged (see the module docstring); prefix_reuse
    shares matched prompt prefixes, pool_pages sizes the pool (default: no
    exhaustion possible).  gen_lens gives per-request budgets (a budget < 1
    still yields the prefill token); eos=-1 disables early stopping.

    Returns stats: completed / tokens / prefills / decode_steps counters,
    tok_s, elapsed_s, mean live-slot `occupancy`, per-request `ttft`
    (seconds to the first token), `outputs` (greedy token ids per request,
    in submission order), per-request admit/finish decode-step indices and
    terminal `status` ("ok", "preempted_resumed" or "rejected"), the
    `preemptions` / `rejections` counts, and per request `admitted_at`, the
    number of tokens it had emitted at each of its admissions ([0] unless
    preempted).  A paged serve adds
    `kv_page_size` and the run's peak `pages_live`, `pages_shared` and
    `paged_capacity_multiplier` (logical / physical pages), and
    `cow_copies`.  Kernel builds and first launches run before the timed
    region.
    """
    cfg = get_config(arch, variant)
    _check_scope(cfg, scheduler, quantize, kv_cache, prefill_chunk, kv_page_size, pool_pages,
                 deadline_ms, faults, speculate, check_invariants, tp)
    if kv_cache == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
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
        if scheduler == "continuous":
            stats = _serve_continuous(cfg, params, prompts, gen_lens, batch, eos, dev, seed,
                                      page_size=kv_page_size, prefix_reuse=prefix_reuse,
                                      pool_pages=pool_pages)
        else:
            stats = _serve_batch(cfg, params, prompts, gen_lens, batch, eos, dev, seed,
                                 page_size=kv_page_size, pool_pages=pool_pages)
    if verbose:
        paged_info = ""
        if "pages_live" in stats:
            paged_info = (f", pages {stats['pages_live']} live / {stats['pages_shared']} "
                          f"shared, {stats['cow_copies']} CoW, capacity "
                          f"x{stats['paged_capacity_multiplier']:.2f}")
        if stats["preemptions"] or stats["rejections"]:
            paged_info += (f", {stats['preemptions']} preemptions / "
                           f"{stats['rejections']} rejections")
        print(f"[serve] {arch} ({scheduler}): {stats['completed']} requests, "
              f"{stats['tokens']} tokens in {stats['elapsed_s']:.2f}s -> "
              f"{stats['tok_s']:.1f} tok/s ({stats['prefills']} prefills, "
              f"{stats['decode_steps']} decode steps, "
              f"occupancy {stats['occupancy']:.2f}{paged_info})", flush=True)
    return stats


def _cache_len(cfg, prompts, gen_lens) -> int:
    """Slot capacity: the longest prompt + its own generation budget, and
    the vlm's patch prefix."""
    need = max(len(p) + g for p, g in zip(prompts, gen_lens))
    return need + (cfg.n_prefix if cfg.family == "vlm" else 0)


def _prefill_extras(cfg, rng, n: int, enc: int, dev) -> dict:
    """The stub frontends' embeddings for one (n, ...) prefill: the vlm's
    patches (n, n_prefix, d), the audio family's frames (n, enc, d), in
    f32 from `rng` (the model casts them to its dtype)."""
    if cfg.family == "vlm":
        shape = (n, cfg.n_prefix, cfg.d_model)
        key = "patches"
    elif cfg.family == "audio":
        shape = (n, enc, cfg.d_model)
        key = "frames"
    else:
        return {}
    return {key: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)}


def _new_stats(nreq: int) -> dict:
    return {"completed": 0, "tokens": 0, "prefills": 0, "decode_steps": 0,
            "outputs": [[] for _ in range(nreq)], "ttft": [None] * nreq,
            "admit_step": [None] * nreq, "finish_step": [None] * nreq,
            "status": [None] * nreq, "preemptions": 0, "rejections": 0,
            "admitted_at": [[] for _ in range(nreq)]}


def _finalize(stats: dict, occ: list, dt: float) -> dict:
    """The run's wall time, tok/s and mean live-slot occupancy."""
    stats["elapsed_s"] = dt
    stats["tok_s"] = stats["tokens"] / dt if dt > 0 else 0.0
    stats["occupancy"] = float(np.mean(occ)) if occ else 0.0
    return stats


def _record_token(stats: dict, rid: int, tok_val: int, eos: int, remaining: int,
                  preempted: bool = False) -> bool:
    """Append one generated token; True if the request just finished (EOS,
    or `remaining` <= 0 tokens of budget left after this one), with status
    "preempted_resumed" if it was ever preempted, else "ok"."""
    stats["outputs"][rid].append(tok_val)
    stats["tokens"] += 1
    if tok_val == eos or remaining <= 0:
        stats["finish_step"][rid] = stats["decode_steps"]
        stats["completed"] += 1
        stats["status"][rid] = "preempted_resumed" if preempted else "ok"
        return True
    return False


def _serve_continuous(cfg, params, prompts, gen_lens, batch, eos, dev, seed, page_size=None,
                      prefix_reuse=True, pool_pages=None) -> dict:
    nreq = len(prompts)
    cache_len = _cache_len(cfg, prompts, gen_lens)
    rng = np.random.default_rng(seed + 1)  # the vlm's patches
    # vlm prompts carry their own random patches in front: equal token ids
    # are not equal keys, so they are never shared
    share = prefix_reuse and cfg.family != "vlm"
    n_prefix = cfg.n_prefix if cfg.family == "vlm" else 0
    prefill_fn = steps_lib.make_prefill_step(cfg)
    decode_fn = steps_lib.make_decode_step_slots(cfg)
    # the admission prefill's scalar-pos cache (int8 for an int8 KV cache):
    # one buffer reused every round (keys past the prompt are masked by
    # kv_lens, never read)
    mini_buf = tf.init_cache(cfg, batch, cache_len, device=dev)

    def mini():
        return {**mini_buf, "pos": 0}

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    paged = page_size is not None
    slot_kw = {}
    if paged:
        max_pages = -(-cache_len // page_size)
        # the default pool cannot run out (every slot's capacity + slack);
        # growth on demand means live pages track actual tokens, and a
        # smaller pool_pages turns page pressure into backpressure and
        # preemption
        num_pages = pool_pages if pool_pages is not None else 1 + batch * (max_pages + 1)
        slot_kw = dict(page_size=page_size, num_pages=num_pages)
        alloc = paging.PageAllocator(num_pages, page_size)
        slot_pages = [[] for _ in range(batch)]
        # host mirror of the page table, copied to the card once per decode
        # step when it changed
        table = np.zeros((batch, max_pages), np.int32)
        table_dirty = [False]

    # warm-up outside the timed region (kernel build, first launches) on a
    # throwaway slot cache; all-padding slots graft nothing
    warm = tf.init_cache(cfg, batch, cache_len, per_slot=True, device=dev, **slot_kw)
    _, warm_mini = prefill_fn(params, zeros((batch, len(prompts[0])), torch.int32), mini(),
                              **_prefill_extras(cfg, rng, batch, 0, dev))
    if paged:
        zc = zeros(1, torch.int64)
        tf.graft_pages(warm, warm_mini, zc, zc, zc, zc)
        tf.copy_pages(warm, zc, zc)
    else:
        tf.insert_slots_cache(warm, warm_mini, np.full(batch, -1))
    warm_tok, _ = decode_fn(params, zeros((batch, 1), torch.int32), warm,
                            zeros(batch, torch.bool))
    warm_tok.cpu()
    del warm, warm_mini, warm_tok

    pending = collections.deque(enumerate(prompts))  # FIFO
    cache = tf.init_cache(cfg, batch, cache_len, per_slot=True, device=dev, **slot_kw)
    tok_dev = zeros((batch, 1), torch.int32)
    active = np.zeros(batch, bool)
    active_dev = zeros(batch, torch.bool)
    slot_req = np.full(batch, -1)
    slot_left = np.zeros(batch, np.int64)
    slot_pos = np.zeros(batch, np.int64)        # next decode write position
    slot_admit_seq = np.zeros(batch, np.int64)  # admission order (victim choice)
    admit_seq = 0
    preempted_ever = [False] * nreq
    stats = _new_stats(nreq)
    if paged:
        stats.update({"kv_page_size": page_size, "pages_live": 0, "pages_shared": 0,
                      "paged_capacity_multiplier": 0.0, "cow_copies": 0})
    occ = []

    def sample_pages():
        """Fold the allocator's current occupancy into the run's peaks."""
        stats["pages_live"] = max(stats["pages_live"], alloc.pages_live())
        stats["pages_shared"] = max(stats["pages_shared"], alloc.pages_shared())
        stats["paged_capacity_multiplier"] = max(stats["paged_capacity_multiplier"],
                                                 alloc.capacity_multiplier())
        stats["cow_copies"] = alloc.cow_copies

    def set_table_row(s, pages):
        table[s] = paging.TRASH_PAGE
        table[s, :len(pages)] = pages
        table_dirty[0] = True

    def free_slot(s):
        """Finish or preemption: release slot s's pages and point its table
        row at the trash page, so its frozen masked writes never land in a
        recycled page."""
        active[s] = False
        slot_req[s] = -1
        if paged:
            alloc.release(slot_pages[s])
            slot_pages[s] = []
            set_table_row(s, [])

    def pick_victim():
        """The newest admission among active slots that own a non-shared
        page (releasing an all-shared slot reclaims nothing)."""
        best, best_seq = None, -1
        for s in range(batch):
            if not active[s] or all(alloc.shared(p) for p in slot_pages[s]):
                continue
            if slot_admit_seq[s] > best_seq:
                best, best_seq = s, slot_admit_seq[s]
        return best

    def preempt(s):
        """Evict slot s and put its request back at the HEAD of the queue;
        its re-admission prefills prompt + emitted tokens and goes on from
        there (bit for bit only where prefill and decode round alike:
        ROADMAP §3)."""
        vid = slot_req[s]
        stats["preemptions"] += 1
        preempted_ever[vid] = True
        free_slot(s)
        pending.appendleft((vid, prompts[vid]))

    def free_up(n_pages):
        """Preempt victims until n_pages pages are free; False if no victim
        is left."""
        while alloc.free_pages() < n_pages:
            v = pick_victim()
            if v is None:
                return False
            preempt(v)
        return True

    def ensure_page(s):
        """Grow slot s's page run to cover this step's write at slot_pos[s];
        a failed allocation preempts a victim, possibly s itself."""
        last_idx = int(slot_pos[s]) // page_size
        while len(slot_pages[s]) <= last_idx:
            while not alloc.free_pages():
                v = pick_victim()
                if v is None:
                    raise paging.PoolExhausted(f"growth for slot {s}: no free page and no victim")
                preempt(v)
                if v == s:
                    return
            slot_pages[s].append(alloc.alloc(1)[0])
            set_table_row(s, slot_pages[s])

    def reclaimable():
        """Pages preemption could free now: active slots' non-shared pages."""
        return sum(1 for s in range(batch) if active[s]
                   for p in slot_pages[s] if not alloc.shared(p))

    def place_paged(group, slots, plen):
        """Page-pointer admission of one prefilled group: match each prompt
        against the registered prefixes, take fresh pages for the rest and
        list the unshared suffix tokens to graft; then, once every member
        has matched and registered, resolve each member's first-write page
        (copy a shared one on write, unpublish an owned one).  Returns
        (placed flags, requeued request ids, graft coordinates, CoW pairs).
        A vlm member's pages hold its patch prefix in front of the prompt:
        total = n_prefix + plen positions."""
        total = plen + n_prefix
        need = total // page_size + 1  # through the first decode write
        placed, requeue = [True] * len(group), []
        coords = ([], [], [], [])
        cow = ([], [])
        cow_reserve = 0  # pages earlier members' second-pass copies will take
        for i, (s, rid, adm, n_em) in enumerate(group):
            will_decode = gen_lens[rid] - n_em - 1 > 0
            while True:
                matched, covered = alloc.match_prefix(adm) if share else ([], 0)
                # a matched partial page is an exact tail: it covers the
                # whole prompt, so the graft never appends into a shared page
                assert covered == total or covered % page_size == 0, (covered, total)
                cow_tail = will_decode and covered == total and total % page_size != 0
                need_new = need - len(matched) + (1 if cow_tail else 0)
                if need_new + cow_reserve <= alloc.free_pages():
                    break
                if not free_up(need_new + cow_reserve):
                    matched = None
                    break
                # victims may have freed registered pages: match again
            if matched is None:
                slots[i] = -1
                placed[i] = False
                requeue.append(rid)
                continue
            alloc.retain(matched)
            plist = matched + alloc.alloc(need - len(matched))
            if cow_tail:
                cow_reserve += 1
            if share:
                alloc.register_prefix(adm, plist[:-(-plen // page_size)])
            slot_pages[s] = plist
            for p in range(covered, total):
                for c, val in zip(coords, (i, p, plist[p // page_size], p % page_size)):
                    c.append(val)
        widx = total // page_size
        for i, (s, rid, adm, n_em) in enumerate(group):
            if not placed[i] or gen_lens[rid] - n_em - 1 <= 0:
                continue
            p = slot_pages[s][widx]
            if alloc.shared(p):
                newp = alloc.cow(p)
                cow[0].append(p)
                cow[1].append(newp)
                slot_pages[s][widx] = newp
            else:
                alloc.invalidate(p)
        for i, (s, _, _, _) in enumerate(group):
            if placed[i]:
                set_table_row(s, slot_pages[s])
        return placed, requeue, coords, cow

    def decode_round():
        """One masked decode step over the slot grid, then the host's
        bookkeeping.  A paged slot first grows its page run for this step's
        write (which may preempt)."""
        nonlocal tok_dev, cache, active_dev
        if paged:
            for s in range(batch):
                if active[s]:
                    ensure_page(s)
            if table_dirty[0]:
                cache["page_table"].copy_(torch.from_numpy(table))
                table_dirty[0] = False
        stepped = active.copy()
        if not stepped.any():
            return
        if not np.array_equal(stepped, active_up):
            active_dev = torch.from_numpy(stepped).to(dev)
            active_up[:] = stepped
        occ.append(stepped.sum() / batch)
        tok_dev, cache = decode_fn(params, tok_dev, cache, active_dev)
        tok_np = tok_dev.cpu().numpy()[:, 0]
        stats["decode_steps"] += 1
        for s in np.flatnonzero(stepped):
            rid = slot_req[s]
            slot_pos[s] += 1
            slot_left[s] -= 1
            if _record_token(stats, rid, int(tok_np[s]), eos, slot_left[s],
                             preempted=preempted_ever[rid]):
                free_slot(s)
        if paged:
            sample_pages()

    active_up = active.copy()  # the mask last copied to active_dev
    t0 = time.time()
    while pending or active.any():
        # admission: every free slot takes the next pending request (strict
        # FIFO).  Paged: the head blocks at the allocator's watermark (free
        # + reclaimable pages: backpressure, never skip-ahead), and a
        # request no pool could hold is rejected.  A preempted request is
        # admitted again with its prompt + emitted tokens.
        admits = []  # (slot, rid, admission prompt, tokens already emitted)
        reserved = 0  # pages this round's earlier picks will allocate
        blocked = False
        for s in range(batch):
            if active[s] or blocked:
                continue
            while pending:
                rid, base = pending[0]
                em = stats["outputs"][rid]
                adm = np.concatenate([base, np.asarray(em, np.int32)]) if em else base
                if paged:
                    total = len(adm) + n_prefix
                    need = total // page_size + 1
                    if need > num_pages - 1:
                        pending.popleft()
                        stats["status"][rid] = "rejected"
                        stats["rejections"] += 1
                        continue
                    matched, covered = alloc.match_prefix(adm) if share else ([], 0)
                    need_new = need - len(matched)
                    if covered == total and total % page_size:
                        need_new += 1  # the first decode write copies the tail
                    if not alloc.can_admit(page_size * (need_new + reserved),
                                           reclaimable=reclaimable()):
                        blocked = True
                        break
                    reserved += need_new
                pending.popleft()
                admits.append((s, rid, adm, len(em)))
                break
        by_len = {}
        for adm in admits:
            by_len.setdefault(len(adm[2]), []).append(adm)
        for plen in sorted(by_len):
            group = by_len[plen]
            block = np.zeros((batch, plen), np.int32)
            slots = np.full(batch, -1, np.int64)
            for i, (s, _, adm, _) in enumerate(group):
                block[i] = adm
                slots[i] = s
            tok0, filled = prefill_fn(params, torch.from_numpy(block).to(dev), mini(),
                                      **_prefill_extras(cfg, rng, batch, 0, dev))
            stats["prefills"] += 1
            placed = [True] * len(group)
            if paged:
                placed, requeue, coords, cow = place_paged(group, slots, plen)
                rows = [i for i in range(len(group)) if placed[i]]
                if rows:
                    cache["pos"][torch.from_numpy(slots[rows]).to(dev)] = plen + n_prefix
                if cow[0]:
                    # matched pages are resident: copy before the graft,
                    # which only writes fresh pages
                    tf.copy_pages(cache, *(torch.tensor(c, device=dev) for c in cow))
                if coords[0]:
                    tf.graft_pages(cache, filled,
                                   *(torch.tensor(c, device=dev) for c in coords))
                for rid in reversed(requeue):
                    pending.appendleft((rid, prompts[rid]))
            else:
                rows = list(range(len(group)))
                tf.insert_slots_cache(cache, filled, slots)
            rows_dev = torch.tensor(rows, device=dev)
            tok_dev[torch.from_numpy(slots[rows]).to(dev)] = tok0[rows_dev]
            tok0_np = tok0.cpu().numpy()[:, 0]  # sync before stamping TTFT
            t_first = time.time() - t0
            for i, (s, rid, _, n_em) in enumerate(group):
                if not placed[i]:
                    continue
                stats["admitted_at"][rid].append(n_em)
                if stats["ttft"][rid] is None:  # a resumed request keeps its first
                    stats["ttft"][rid] = t_first
                    stats["admit_step"][rid] = stats["decode_steps"]
                rem = gen_lens[rid] - n_em - 1
                if not _record_token(stats, rid, int(tok0_np[i]), eos, rem,
                                     preempted=preempted_ever[rid]):
                    active[s] = True
                    slot_req[s] = rid
                    slot_left[s] = rem
                    slot_pos[s] = plen + n_prefix
                    slot_admit_seq[s] = admit_seq
                    admit_seq += 1
                elif paged:
                    free_slot(s)  # finished on its prefill token
            if paged:
                sample_pages()
        if not active.any():
            continue  # every admitted request finished on its prefill token
        decode_round()
    dt = time.time() - t0
    if paged:
        sample_pages()
        alloc.leak_check()  # every page back on the free list
    return _finalize(stats, occ, dt)


def _serve_batch(cfg, params, prompts, gen_lens, batch, eos, dev, seed, page_size=None,
                 pool_pages=None) -> dict:
    """Batch-at-a-time: FIFO groups of `batch` requests, one (batch, T)
    prefill each (padding rows included), then lockstep decode on a
    scalar-pos cache until the whole group has finished; a finished row
    idles until then.

    Paged (page_size): each group gets a fresh pool and allocator; its live
    rows take the pages prompt (behind the vlm's patch prefix) + first
    decode write need, grow on demand at page boundaries, and the group is
    capped so every member's reservation fits the pool.  A growth that finds no free page preempts the newest
    live member: its emitted tokens are discarded and its request re-served
    from the original prompt in a later group (a full recompute).  A row
    that already owns the whole pool and needs more is rejected; a prompt no
    pool could hold rejects every request.  Every group drain runs the
    allocator's leak check.  No prefix sharing: the capacity multiplier
    stays 1.0.  The group's prefill draws its vlm patches or audio frames;
    the audio family's cache holds the encoder output for the decode steps."""
    nreq = len(prompts)
    prompt_len = len(prompts[0])
    if any(len(p) != prompt_len for p in prompts):
        raise ValueError(
            "batch scheduler stacks prompts into one (batch, T) prefill and "
            "needs uniform prompt lengths; ragged prompts need --scheduler "
            "continuous (per-slot prefill)")
    cache_len = _cache_len(cfg, prompts, gen_lens)
    enc = cfg.encoder.n_frames if cfg.family == "audio" else 0
    n_prefix = cfg.n_prefix if cfg.family == "vlm" else 0
    rng = np.random.default_rng(seed + 1)  # the vlm's patches, the audio frames
    prefill_fn = steps_lib.make_prefill_step(cfg)
    decode_fn = steps_lib.make_serve_step(cfg)
    paged = page_size is not None
    if paged:
        max_pages = -(-cache_len // page_size)
        num_pages = pool_pages if pool_pages is not None else 1 + batch * max_pages
        # pages through the first decode write, the vlm's patch prefix
        # included; later writes grow on demand
        need_admit = (prompt_len + n_prefix) // page_size + 1

    pending = collections.deque(enumerate(prompts))  # FIFO
    stats = _new_stats(nreq)
    preempted_ever = [False] * nreq
    if paged:
        stats.update({"kv_page_size": page_size, "pages_live": 0, "pages_shared": 0,
                      "paged_capacity_multiplier": 0.0, "cow_copies": 0})

    def group_cache(nact):
        """A fresh cache for one group and, paged, its allocator and the
        live rows' page runs (padding rows point at the trash page)."""
        if not paged:
            return tf.init_cache(cfg, batch, cache_len, device=dev, enc_frames=enc), None, None
        cache = tf.init_cache(cfg, batch, cache_len, page_size=page_size,
                              num_pages=num_pages, device=dev, enc_frames=enc)
        galloc = paging.PageAllocator(num_pages, page_size)
        row_pages = [galloc.alloc(need_admit) if i < nact else [] for i in range(batch)]
        table = np.zeros(tuple(cache["page_table"].shape), np.int32)
        for i in range(nact):
            table[i, :len(row_pages[i])] = row_pages[i]
        cache["page_table"].copy_(torch.from_numpy(table))
        stats["pages_live"] = max(stats["pages_live"], galloc.pages_live())
        stats["paged_capacity_multiplier"] = max(stats["paged_capacity_multiplier"],
                                                 galloc.capacity_multiplier())
        return cache, galloc, row_pages

    # warm-up outside the timed region (kernel build, first launches) with
    # ZERO live rows: a pool too small for any group must reject at
    # admission, not fail allocating the warm-up cache
    warm_tok, warm_cache = prefill_fn(
        params, torch.zeros((batch, prompt_len), dtype=torch.int32, device=dev),
        group_cache(0)[0], **_prefill_extras(cfg, rng, batch, enc, dev))
    warm_tok, warm_cache = decode_fn(params, warm_tok, warm_cache)
    warm_tok.cpu()
    del warm_tok, warm_cache

    occ = []
    t0 = time.time()
    while pending:
        if paged:
            if need_admit > num_pages - 1:
                # no request fits even an empty pool (uniform prompt
                # lengths: if one cannot, none can): reject, never hang
                while pending:
                    rid, _ = pending.popleft()
                    stats["status"][rid] = "rejected"
                    stats["rejections"] += 1
                break
            # every member's reservation fits up front; growth pressure
            # during the drain is resolved by preemption
            gsize = min(batch, (num_pages - 1) // need_admit, len(pending))
        else:
            gsize = min(batch, len(pending))
        group = [pending.popleft() for _ in range(gsize)]
        nact = len(group)
        block = np.stack([p for _, p in group]
                         + [np.zeros(prompt_len, np.int32)] * (batch - nact))
        extras = _prefill_extras(cfg, rng, batch, enc, dev)
        cache, galloc, row_pages = group_cache(nact)
        if paged:
            # host mirror of the page table, copied to the card before a
            # decode step whenever it changed
            table = cache["page_table"].cpu().numpy()
            table_dirty = False
        tok, cache = prefill_fn(params, torch.from_numpy(block).to(dev), cache, **extras)
        stats["prefills"] += 1
        tok_np = tok.cpu().numpy()[:, 0]  # sync before stamping TTFT
        done = np.zeros(batch, bool)
        done[nact:] = True
        left = np.zeros(batch, np.int64)
        row_pos = np.full(batch, prompt_len + n_prefix, np.int64)  # next write position

        def release_row(i):
            nonlocal table_dirty
            galloc.release(row_pages[i])
            row_pages[i] = []
            table[i] = paging.TRASH_PAGE
            table_dirty = True

        def preempt_row(i):
            """Full recompute: discard the victim's emitted tokens and
            re-serve its original prompt in a later group."""
            rid = group[i][0]
            stats["preemptions"] += 1
            preempted_ever[rid] = True
            stats["tokens"] -= len(stats["outputs"][rid])
            stats["outputs"][rid] = []
            done[i] = True
            if paged:
                release_row(i)
            pending.appendleft(group[i])

        t_first = time.time() - t0
        for i, (rid, _) in enumerate(group):
            if stats["ttft"][rid] is None:  # a re-served request keeps its first
                stats["ttft"][rid] = t_first
                stats["admit_step"][rid] = stats["decode_steps"]
            stats["admitted_at"][rid].append(0)
            left[i] = gen_lens[rid] - 1
            done[i] = _record_token(stats, rid, int(tok_np[i]), eos, left[i],
                                    preempted=preempted_ever[rid])
            if done[i] and paged:
                release_row(i)
        while not done.all():
            if paged:
                # grow every live row's run to cover this step's write
                for i in range(nact):
                    last_idx = int(row_pos[i]) // page_size
                    while not done[i] and len(row_pages[i]) <= last_idx:
                        widx = len(row_pages[i])
                        while not galloc.free_pages() and not done[i]:
                            live = [j for j in range(nact) if not done[j]]
                            if live == [i]:
                                # i owns every page and needs more: a
                                # recompute cannot help, the sequence does
                                # not fit the pool
                                rid = group[i][0]
                                stats["tokens"] -= len(stats["outputs"][rid])
                                stats["outputs"][rid] = []
                                stats["status"][rid] = "rejected"
                                stats["rejections"] += 1
                                done[i] = True
                                release_row(i)
                                break
                            preempt_row(live[-1])
                        if done[i]:
                            break
                        newp = galloc.alloc(1)[0]
                        row_pages[i].append(newp)
                        table[i, widx] = newp
                        table_dirty = True
                if table_dirty:
                    cache["page_table"].copy_(torch.from_numpy(table))
                    table_dirty = False
            if done.all():
                break
            occ.append((~done).sum() / batch)
            tok, cache = decode_fn(params, tok, cache)
            tok_np = tok.cpu().numpy()[:, 0]
            stats["decode_steps"] += 1
            for i, (rid, _) in enumerate(group):
                if done[i]:
                    continue
                row_pos[i] += 1
                left[i] -= 1
                done[i] = _record_token(stats, rid, int(tok_np[i]), eos, left[i],
                                        preempted=preempted_ever[rid])
                if done[i] and paged:
                    release_row(i)
            if paged:
                stats["pages_live"] = max(stats["pages_live"], galloc.pages_live())
        if paged:
            galloc.leak_check()  # every page of the group back on the free list
    return _finalize(stats, occ, time.time() - t0)


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
                    help="continuous: slot-level admission; batch: FIFO groups that "
                         "drain together (the rwkv and hybrid families' scheduler)")
    ap.add_argument("--quantize", default="none", choices=("none", "int8"),
                    help="int8: block-scaled int8 projection weights (W8A16)")
    ap.add_argument("--kv-cache", default="model", choices=("model", "int8"),
                    help="int8: int8 KV cache with one f32 scale per (token, head)")
    ap.add_argument("--kv-page-size", type=int, default=0,
                    help="store the KV cache paged, pages of this many tokens "
                         "(0 = dense per-slot cache)")
    ap.add_argument("--prefix-reuse", default="on", choices=("on", "off"),
                    help="paged: back a matched prompt prefix with the same pages")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="paged pool size (0 = sized so it cannot run out); small "
                         "pools block admission and preempt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return serve(args.arch, args.variant, args.requests, args.batch,
                 args.prompt_len, args.gen, seed=args.seed,
                 scheduler=args.scheduler, quantize=args.quantize, kv_cache=args.kv_cache,
                 kv_page_size=args.kv_page_size or None,
                 prefix_reuse=args.prefix_reuse == "on",
                 pool_pages=args.pool_pages or None, device=args.device)

if __name__ == "__main__":
    main()
