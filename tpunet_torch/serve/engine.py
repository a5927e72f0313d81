"""Continuous-batching decode engine over a paged KV pool, port of
``tpunet/serve/engine.py``.

One masked step serves the whole slot pool: each iteration feeds every
active slot its next token at its own position (per-row positions and an
active mask, ``tpunet_torch.models.vit.ServeStep``), so requests join
mid-flight and finished ones free their slot. Prefill runs through the
same masked call as a chunked multi-token step padded to one of a fixed
set of length buckets, so the card sees ``[slots, 1]`` decode shapes and
one ``[slots, bucket]`` shape per bucket, nothing else. A step is one
eager PyTorch call under ``torch.inference_mode()`` on the model's
device; the KV cache is per-layer tensors written in place, never
copied.

KV memory is PAGED by default (``ServeConfig.paged_kv``;
``--no-paged-kv`` keeps the dense ``[slots, max_seq_len]`` pool): per
layer, K/V live in a shared pool of ``kv_pages`` pages of
``kv_page_tokens`` tokens each, addressed through per-slot page tables
the engine owns on the host. Pages are allocated on advance, freed on
finish and recycled; when the pool is exhausted the YOUNGEST blocked
slot is preempted back to the queue (its progress is kept and resumed by
re-prefilling prompt + generated, so token streams never restart).
int8 page payloads (``kv_dtype``, a float32 scale a page row) halve the
bf16 page cost again.

Prefix KV cache (``ServeConfig.prefix_cache``, on by default with
paging; ``tpunet_torch/serve/prefixcache/``): finished prefill pages
become immutable, content-addressed, refcounted objects inside the SAME
pool. Admission pins the longest cached page-aligned prefix into the new
slot's page table (zero prefill compute for those tokens), re-prefills
only the suffix, and copies on write at the divergence page when the
full prefix is cached; release unpins, pool pressure LRU-evicts. With
``--prefix-store`` the pages spill to a shared filesystem (fsatomic
first-writer-wins) and a fresh replica warms from the fleet's prefix set
when it starts.

Speculative decoding (``ServeConfig.spec_decode``;
``tpunet_torch/serve/spec.py``): a drafter (the serving model itself at
width 1.0, else a narrower LM) proposes ``spec_k`` tokens a slot against
its own page pool, one ``[slots, K+1]`` verify forward over the main
pool scores them, and every emitted token comes from the verify, so the
stream is the spec-off stream at any acceptance rate.

Sampling is DEVICE-side by default (``ServeConfig.device_sampling``):
one ``[slots]``-wide batched temperature/top-k/top-p step
(``tpunet_torch/serve/sampling.py``, a counter-based draw per (seed,
step)) runs after the model, so only sampled tokens cross to the host.
``sample_token`` below is the host-side parity reference and the
``--no-device-sampling`` path; greedy output is token-identical to
``models.lm.generate`` through either.

Obs: SLO counters, gauges and histograms land in a
``tpunet_torch.obs.registry.Registry`` under the JAX package's
``serve_*`` names (``docs/metrics_schema.md`` ``obs_serve``), prefill
and decode run under ``tpunet/serve_prefill`` / ``tpunet/serve_decode``
spans that also land in the flight recorder's ring, and a periodic
``obs_serve`` record goes to every attached sink. Serve-tier fault
injection (``--chaos``, ``tpunet_torch/serve/chaos.py``) hooks token
production, prefill dispatch and the engine loop.

Not here: the AOT warm start (out of scope, ``config.AOT_CACHE_SCOPED_OUT``)
and tensor-parallel serving (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from tpunet_torch.models.convert import load_state_dict
from tpunet_torch.models.lm import init_lm
from tpunet_torch.models.vit import PagedKV
from tpunet_torch.obs import flightrec, tracing
from tpunet_torch.obs.flightrec.threads import THREADS
from tpunet_torch.obs.registry import Registry
from tpunet_torch.obs.spans import span
from tpunet_torch.serve import chaos as serve_chaos
from tpunet_torch.serve import spec as serve_spec
from tpunet_torch.serve.prefixcache import PrefixCache
from tpunet_torch.serve.prefixcache import keys as pk
from tpunet_torch.serve.sampling import (batched_sample,
                                         batched_sample_positions)
from tpunet_torch.serve.scheduler import (FINISH_CANCELLED, FINISH_DEADLINE,
                                          FINISH_DRAIN, FINISH_ERROR,
                                          FINISH_LENGTH, FINISH_STOP,
                                          DrainingError, GenerateRequest,
                                          RequestQueue)


class PromptTooLongError(Exception):
    """Prompt exceeds the largest prefill bucket or the KV length."""


@contextlib.contextmanager
def _ring_span(name: str):
    """A profiler span whose begin/end also land in the flight-recorder
    ring. ``span_end`` sits in a finally so a raising device call cannot
    leave a dangling open span."""
    flightrec.record("span", name)
    try:
        with span(name):
            yield
    finally:
        flightrec.record("span_end", name)


def sample_token(logits: np.ndarray, req: GenerateRequest) -> int:
    """Host-side next-token choice from one row of logits [V] (a copy of
    tpunet's, numpy, so its draws equal tpunet's on the same logits).

    Greedy (temperature <= 0) is exact argmax. Sampling mirrors
    ``models.lm.filter_logits``: top-k truncation first, then nucleus
    over the renormalized post-top-k distribution; the draw uses the
    request's own seeded numpy Generator (deterministic per request,
    independent across slots).
    """
    if req.temperature <= 0:
        return int(np.argmax(logits))
    lg = logits.astype(np.float64) / req.temperature
    v = lg.shape[-1]
    if req.top_k > 0 and req.top_k < v:
        kth = np.sort(lg)[-req.top_k]
        lg = np.where(lg >= kth, lg, -np.inf)
    if 0.0 < req.top_p < 1.0:
        srt = np.sort(lg)[::-1]
        probs = np.exp(srt - srt.max())
        probs /= probs.sum()
        keep = np.cumsum(probs) - probs < req.top_p
        cutoff = srt[keep].min()
        lg = np.where(lg >= cutoff, lg, -np.inf)
    lg -= lg.max()
    p = np.exp(lg)
    p /= p.sum()
    return int(req.rng().choice(v, p=p))


def build_serve_record(reg, *, queue_depth: int, active_slots: int,
                       slots: int, uptime_s: float, window_s: float,
                       final: bool = False) -> dict:
    """The ``obs_serve`` record body (docs/metrics_schema.md), a copy of
    tpunet's: cumulative counters + window histogram summaries. The
    TTFT/e2e histograms also export their bounded window sample (the
    fleet aggregator merges replica percentiles from sample points)."""
    record = {
        "uptime_s": round(uptime_s, 3),
        "window_s": round(window_s, 3),
        "queue_depth": queue_depth,
        "active_slots": active_slots,
        "slots": slots,
        "requests_total": int(
            reg.counter("serve_requests_total").value),
        "requests_completed": int(
            reg.counter("serve_requests_completed").value),
        "requests_rejected": int(
            reg.counter("serve_requests_rejected").value),
        "tokens_total": int(reg.counter("serve_tokens_total").value),
        "decode_steps_total": int(
            reg.counter("serve_decode_steps_total").value),
        "prefills_total": int(
            reg.counter("serve_prefills_total").value),
    }
    for name, key in (("serve_ttft_s", "ttft"),
                      ("serve_token_s", "token_latency"),
                      ("serve_e2e_s", "e2e"),
                      ("serve_prefill_s", "prefill")):
        hist = reg.histogram(name)
        summ = hist.summary()
        for stat in ("p50", "p90", "p99", "mean", "count"):
            if stat in summ:
                record[f"{key}_{stat}_s" if stat != "count"
                       else f"{key}_count"] = (
                    round(summ[stat], 6) if stat != "count"
                    else int(summ[stat]))
        if key in ("ttft", "e2e") and summ:
            record[f"{key}_sample"] = [
                round(v, 6) for v in hist.export_sample()]
            if summ.get("approx"):
                record[f"{key}_approx"] = 1
    # Paged-KV pool state (serve_kv_* gauges; zeros on a dense pool).
    for gauge_name, field in (("serve_kv_pages_total", "kv_pages_total"),
                              ("serve_kv_pages_used", "kv_pages_used")):
        val = reg.gauge(gauge_name).value
        record[field] = int(val) if val is not None else 0
    bpt = reg.gauge("serve_kv_bytes_per_token").value
    record["kv_bytes_per_token"] = (round(float(bpt), 2)
                                    if bpt is not None else 0)
    # Prefix KV cache (serve_prefix_* instruments; zeros when off).
    for cname, field in (
            ("serve_prefix_lookups_total", "prefix_lookups_total"),
            ("serve_prefix_hits_total", "prefix_hits_total"),
            ("serve_prefix_hit_tokens_total", "prefix_hit_tokens_total"),
            ("serve_prefix_inserts_total", "prefix_inserts_total"),
            ("serve_prefix_evictions_total", "prefix_evictions_total"),
            ("serve_prefix_cow_total", "prefix_cow_total"),
            ("serve_prefix_spills_total", "prefix_spills_total"),
            ("serve_prefix_warm_loads_total", "prefix_warm_loads_total")):
        record[field] = int(reg.counter(cname).value)
    pages_cached = reg.gauge("serve_prefix_pages_cached").value
    record["prefix_pages_cached"] = (int(pages_cached)
                                     if pages_cached is not None else 0)
    lookups = record["prefix_lookups_total"]
    record["prefix_hit_rate"] = (
        round(record["prefix_hits_total"] / lookups, 4) if lookups
        else 0.0)
    # Speculative decoding (serve_spec_* instruments; zeros with spec
    # off): acceptance rate is the drafter-quality signal.
    for cname, field in (
            ("serve_spec_draft_tokens_total", "spec_draft_tokens_total"),
            ("serve_spec_accepted_tokens_total",
             "spec_accepted_tokens_total"),
            ("serve_spec_rejected_tokens_total",
             "spec_rejected_tokens_total"),
            ("serve_spec_verify_steps_total", "spec_verify_steps_total")):
        record[field] = int(reg.counter(cname).value)
    drafted = record["spec_draft_tokens_total"]
    record["spec_acceptance_rate"] = (
        round(record["spec_accepted_tokens_total"] / drafted, 4)
        if drafted else 0.0)
    verifies = record["spec_verify_steps_total"]
    record["spec_accepted_tokens_per_verify"] = (
        round(record["spec_accepted_tokens_total"] / verifies, 4)
        if verifies else 0.0)
    if final:
        record["final"] = True
    return record


def _host(t: torch.Tensor) -> np.ndarray:
    """A pool slice as a host numpy array (bf16 as its int16 bits: numpy
    has no bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_host` for a slice of ``like``'s pool."""
    t = torch.from_numpy(a)
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


class _Slot:
    """Host-side bookkeeping for one KV-cache row."""

    __slots__ = ("req", "pos", "next_token", "generated", "pages",
                 "pinned", "seq")

    def __init__(self, req: GenerateRequest, pos: int, next_token: int,
                 generated: int = 1, seq: int = 0):
        self.req = req
        self.pos = pos            # next cache write position
        self.next_token = next_token
        self.generated = generated  # tokens produced (resume-aware)
        self.pages: List[int] = []  # PRIVATE paged-KV pages (table
        #                             indices from len(pinned) up)
        self.pinned: List = []    # prefix-cache nodes this slot maps
        #                           read-only (table indices 0..k-1)
        self.seq = seq            # admission ordinal (preempt youngest)


class Engine:
    """Slot-pool continuous-batching engine for one LM.

    ``model`` is a ``tpunet_torch.models.lm.TransformerLM`` (e.g. from
    ``infer.generate.load_lm``); the engine runs where its parameters
    are. ``prefix_store`` is a ``prefixcache.PrefixStore`` (the spill
    store); ``drafter_params`` a drafter state dict in the port's LM
    layout (e.g. from ``spec.fit_drafter``), which wins over
    ``cfg.spec_draft_checkpoint``. The engine owns a single background
    thread; ``submit`` is thread-safe and non-blocking (bounded queue).
    """

    def __init__(self, model, cfg, *, registry=None, prefix_store=None,
                 drafter_params=None):
        self.model = model
        self.cfg = cfg
        self.device = model.pos_embed.device
        self.registry = registry if registry is not None else Registry()
        self.max_seq_len = int(model.max_len)
        self.slots = int(cfg.slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {cfg.slots}")
        self.buckets = tuple(sorted(
            b for b in cfg.prefill_buckets if b <= self.max_seq_len))
        if not self.buckets:
            self.buckets = (self.max_seq_len,)
        self.queue = RequestQueue(cfg.queue_max,
                                  on_finish=self._account_finish)
        self._active: List[Optional[_Slot]] = [None] * self.slots

        # -- paged KV geometry (host-owned allocator) ------------------
        self.device_sampling = bool(cfg.device_sampling)
        self.page_tokens = int(cfg.kv_page_tokens)
        if self.page_tokens < 1:
            raise ValueError(
                f"kv_page_tokens must be >= 1, got {cfg.kv_page_tokens}")
        self.pages_per_slot = -(-self.max_seq_len // self.page_tokens)
        self._paged_kv = None
        self._page_table = None
        if cfg.paged_kv:
            usable = int(cfg.kv_pages) or self.slots * self.pages_per_slot
            if usable < 1:
                raise ValueError(f"kv_pages must be >= 1, got "
                                 f"{cfg.kv_pages}")
            self.kv_pages_usable = usable
            # Free list yields ascending page ids (pop from the end);
            # freed pages re-enter at the end, so recycling is LIFO —
            # a just-freed hot page is the next one handed out.
            self._free_pages = list(range(usable, 0, -1))
            self._page_table = np.zeros(
                (self.slots, self.pages_per_slot), np.int32)
            # pages + 1: page 0 is the reserved garbage page (inactive
            # rows and padded prefill tails write there; the allocator
            # never hands it out).
            self._paged_kv = PagedKV(pages=usable + 1,
                                     page_tokens=self.page_tokens,
                                     dtype=cfg.kv_dtype)
            self._kv_pages_touched: set = set()
        elif cfg.kv_dtype not in ("auto",):
            raise ValueError(
                f"kv_dtype={cfg.kv_dtype!r} requires the paged KV "
                "cache (drop --no-paged-kv or use kv_dtype auto)")
        # -- prefix KV cache (tpunet_torch/serve/prefixcache/) ---------
        # Refcounted content-addressed pages INSIDE the page pool,
        # bounded below the pool so paying slots always have headroom;
        # requires paging (the dense pool has no page identity).
        self._prefix = None
        self._prefix_store = None
        if self._paged_kv is not None and cfg.prefix_cache:
            cap = int(cfg.prefix_cache_pages)
            if cap <= 0:
                cap = self.kv_pages_usable // 2
            if cap > 0:
                self._prefix = PrefixCache(self.page_tokens, cap,
                                           registry=self.registry)
                self._prefix_store = prefix_store
        # -- speculative decoding (tpunet_torch/serve/spec.py) ---------
        # The drafter proposes spec_k tokens per active slot against its
        # OWN paged pool, then ONE [slots, K+1] verify over the main pool
        # scores them. The drafter pool shares THIS page table (same page
        # ids, same page_tokens), so allocate-on-advance, cursor rewind,
        # release and preemption keep both pools in lockstep with no
        # extra allocator state.
        self.spec_decode = bool(cfg.spec_decode)
        self.spec_k = int(cfg.spec_k)
        self._drafter = None
        self._draft_cache = None
        self._drafter_paged_kv = None
        if self.spec_decode:
            self._drafter = self._build_drafter(drafter_params)
            self._drafter_paged_kv = PagedKV(
                pages=self.kv_pages_usable + 1,
                page_tokens=self.page_tokens, dtype=cfg.kv_dtype)
            self._draft_cache = self._drafter.init_paged_cache(
                self._drafter_paged_kv)
        self._admit_seq = 0
        # Serve-tier fault injector (--chaos): the engine fires the
        # token/prefill/stall hooks, the HTTP frontend the probe/stream
        # ones. None when unarmed.
        self.chaos = serve_chaos.install(cfg.chaos)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._drain_kill = threading.Event()
        self._drained = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_handle = None       # flightrec registry handle
        self.error: Optional[str] = None
        self._last_emit = time.perf_counter()
        self._started = time.perf_counter()

        # -- the device step and the pool ------------------------------
        # One callable (tests may swap it): [slots, 1] decode plus one
        # [slots, bucket] call per prefill bucket.
        self._step = self._masked_step
        if self._paged_kv is not None:
            self._cache = model.init_paged_cache(self._paged_kv)
        else:
            self._cache = model.init_cache(self.slots, self.max_seq_len)
        self._init_kv_gauges()

    def _build_drafter(self, drafter_params):
        """The spec drafter, after tpunet's checks of the spec levers: the
        serving model itself at width 1.0 (self-speculation: it still has
        its own pool, as it runs ahead of the verified cursor), else the
        serving model's clone at ``drafter_model_config``'s width, holding
        ``drafter_params``, the ``spec_draft_checkpoint`` npz, or a seeded
        init (correct, but it accepts next to nothing: fit a drafter for
        real traffic)."""
        cfg = self.cfg
        if self._paged_kv is None:
            raise ValueError(
                "spec_decode requires the paged KV cache (drop "
                "--no-paged-kv): rejection is a page-table cursor rewind")
        if not self.device_sampling:
            raise ValueError(
                "spec_decode requires device sampling (drop "
                "--no-device-sampling): acceptance compares the drafter "
                "against the sampler's per-(seed, step) choices")
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {cfg.spec_k}")
        wm = float(cfg.spec_draft_width_mult)
        if wm <= 0:
            raise ValueError(
                f"spec_draft_width_mult must be > 0, got {wm}")
        if wm == 1.0:
            return self.model
        heads = self.model.heads
        drafter = self.model.clone(
            hidden=max(heads, int(self.model.hidden * wm) // heads * heads))
        if drafter_params is None and cfg.spec_draft_checkpoint:
            drafter_params = serve_spec.load_drafter_params(
                cfg.spec_draft_checkpoint, drafter)
        if drafter_params is None:
            init_lm(drafter, torch.Generator().manual_seed(0))
        else:
            load_state_dict(drafter, drafter_params)
        return drafter.to(self.device)

    # -- the device calls -------------------------------------------------

    def _upload(self, parts, sample: bool = False):
        """Host int arrays -> one int64 buffer on the device, split back
        into one view each, in order (one copy for a call's inputs).
        Returns (the views, the sampler's inputs): with ``sample``, the
        device sampler's per-slot (temperature, top_k, top_p, seeds,
        steps), the ints riding the same buffer and the floats one float32
        buffer; None without ``sample`` or when no resident row samples
        (every choice is then the rows' argmax: JAX's
        ``lax.cond(any(temperature > 0))``, decided on the host)."""
        draw = None
        if sample:
            temp, top_k, top_p, seeds, steps = self._sampling_args()
            if (temp > 0).any():
                draw = np.concatenate([temp, top_p])
                parts = list(parts) + [top_k, seeds, steps]
        ints = torch.from_numpy(np.concatenate(
            [np.asarray(x, np.int64).reshape(-1) for x in parts])
        ).to(self.device)
        dev = list(torch.split(ints, [np.asarray(x).size for x in parts]))
        if draw is None:
            return dev, None
        n = self.slots
        fl = torch.from_numpy(draw).to(self.device)
        top_k_d, seeds_d, steps_d = dev[-3:]
        return dev[:-3], (fl[:n], top_k_d, fl[n:], seeds_d, steps_d)

    @staticmethod
    def _choose(logits: torch.Tensor, samp, offset: int = 0):
        """The chosen tokens of float32 ``logits`` [n, V] (at each slot's
        step + ``offset``) or [n, T, V] (position j at step + j)."""
        if samp is None:
            return logits.argmax(-1)
        temp, top_k, top_p, seeds, steps = samp
        if logits.dim() == 3:
            return batched_sample_positions(logits, temp, top_k, top_p,
                                            seeds, steps)
        return batched_sample(logits, temp, top_k, top_p, seeds,
                              steps + offset)

    def _forward(self, model, cache, paged_kv, toks, positions, active,
                 table):
        """One masked call of ``model`` over its pool: ``toks`` [slots, W]
        at per-row ``positions`` gated by ``active``, K/V written into
        ``cache`` in place. Returns the logits [slots, W, V] float32."""
        kw = {}
        if paged_kv is not None:
            kw = dict(paged_kv=paged_kv,
                      page_table=table.view(self.slots, -1))
        logits, _ = model(toks.view(self.slots, -1), pos_offset=positions,
                          cache=cache, decode_active=active.bool(), **kw)
        return logits

    @torch.inference_mode()
    def _masked_step(self, toks: np.ndarray, positions: np.ndarray,
                     active: np.ndarray, last_idx: np.ndarray):
        """One masked call over the pool: ``toks`` [slots, W] at per-row
        ``positions`` gated by ``active``, K/V written into the cache in
        place. Returns the chosen int tokens [slots] of each row's
        ``last_idx`` column (device sampling), else that column's float32
        logits [slots, V], on the host."""
        parts = [toks, positions, active, last_idx]
        if self._paged_kv is not None:
            parts.append(self._page_table)
        dev, samp = self._upload(parts, sample=self.device_sampling)
        table = dev[4] if self._paged_kv is not None else None
        logits = self._forward(self.model, self._cache, self._paged_kv,
                               *dev[:3], table)
        rows = logits[torch.arange(self.slots, device=self.device), dev[3]]
        if not self.device_sampling:
            return rows.cpu().numpy()
        return self._choose(rows, samp).cpu().numpy()

    @torch.inference_mode()
    def _draft_prefill_step(self, toks: np.ndarray, positions: np.ndarray,
                            active: np.ndarray) -> None:
        """The drafter's write-only masked call over its own pool (the
        main page table)."""
        dev, _ = self._upload([toks, positions, active, self._page_table])
        self._forward(self._drafter, self._draft_cache,
                      self._drafter_paged_kv, *dev)

    @torch.inference_mode()
    def _draft_burst_step(self, first: np.ndarray, positions: np.ndarray,
                          active: np.ndarray) -> np.ndarray:
        """K+1 drafter steps: step j consumes token t_j at position pos+j,
        writes the drafter's K/V there, and chooses d_{j+1} at the SAME
        (seed, step s0+j) the verify will use — lockstep steps are what
        make a perfect drafter accept at temperature > 0 too. The K+1'th
        draft is dropped, but its K/V write keeps the drafter pool gapless
        after a full acceptance. The tokens stay on the device between
        steps. Returns the drafts d_1..d_K [slots, K] on the host."""
        (tok, pos, act, table), samp = self._upload(
            [first, positions, active, self._page_table], sample=True)
        drafts = []
        for j in range(self.spec_k + 1):
            logits = self._forward(self._drafter, self._draft_cache,
                                   self._drafter_paged_kv, tok, pos + j,
                                   act, table)
            tok = self._choose(logits[:, 0], samp, offset=j)
            drafts.append(tok)
        return torch.stack(drafts[:-1], 1).cpu().numpy()

    @torch.inference_mode()
    def _verify_step(self, toks: np.ndarray, positions: np.ndarray,
                     active: np.ndarray) -> np.ndarray:
        """ONE [slots, K+1] forward over the main pool scoring
        [next_token, d_1..d_K] at positions pos..pos+K: the choice c_j a
        position, position j at step s0+j. Returns [slots, K+1] on the
        host."""
        dev, samp = self._upload([toks, positions, active,
                                  self._page_table], sample=True)
        logits = self._forward(self.model, self._cache, self._paged_kv,
                               *dev)
        return self._choose(logits, samp).cpu().numpy()

    def _sampling_args(self):
        """Per-slot sampling parameters for the device sampler:
        temperature/top-k/top-p/seed from each resident request, plus
        each slot's generated-token count (the per-step key, so a
        preempted-and-resumed request continues its exact sample
        stream)."""
        n = self.slots
        temp = np.zeros(n, np.float32)
        top_k = np.zeros(n, np.int64)
        top_p = np.zeros(n, np.float32)
        seeds = np.zeros(n, np.int64)
        steps = np.zeros(n, np.int64)
        for i, slot in enumerate(self._active):
            if slot is None:
                continue
            r = slot.req
            temp[i] = r.temperature
            top_k[i] = r.top_k
            top_p[i] = r.top_p
            seeds[i] = r.seed    # admission-validated into [0, 2**31)
            steps[i] = len(r.tokens)
        return temp, top_k, top_p, seeds, steps

    # -- pool bookkeeping -----------------------------------------------

    def kv_pool_bytes(self) -> int:
        """Resident bytes of the KV cache (the page pool with the scales
        of int8 pages when paged; the dense [slots, max_seq_len] pool
        otherwise)."""
        return self._cache.nbytes()

    def drafter_pool_bytes(self) -> int:
        """Resident bytes of the drafter's KV pool (0 with spec off),
        apart from ``kv_pool_bytes``: it is the spec lever's EXTRA memory
        cost (width 0.5 is about +50% KV bytes)."""
        return 0 if self._draft_cache is None else self._draft_cache.nbytes()

    def kv_bytes_per_token(self) -> float:
        """KV bytes pinned per cacheable token position across the whole
        pool."""
        if self._paged_kv is not None:
            rows = self._paged_kv.pages * self.page_tokens
        else:
            rows = self.slots * self.max_seq_len
        return self.kv_pool_bytes() / max(1, rows)

    def _init_kv_gauges(self) -> None:
        reg = self.registry
        reg.gauge("serve_kv_bytes_per_token").set(
            round(self.kv_bytes_per_token(), 2))
        if self._paged_kv is not None:
            reg.gauge("serve_kv_pages_total").set(self.kv_pages_usable)
            reg.gauge("serve_kv_pages_used").set(0)
        if self._prefix is not None:
            reg.gauge("serve_prefix_pages_cached").set(0)

    def _update_kv_gauges(self) -> None:
        if self._paged_kv is not None:
            self.registry.gauge("serve_kv_pages_used").set(
                self.kv_pages_usable - len(self._free_pages))

    # -- paged-KV page allocator (engine thread only) -------------------

    def _alloc_pages_for(self, slot_i: int, n_tokens: int,
                         first_index: int = 0):
        """Allocate pages covering ``n_tokens`` prefill positions for an
        admission, from page-table index ``first_index`` (indices below
        it are prefix-cache pins); None when the pool cannot cover it
        right now (the request stays queued). All-or-nothing; under
        pressure, unpinned prefix-cache pages are LRU-evicted first."""
        need = -(-n_tokens // self.page_tokens) - first_index
        while len(self._free_pages) < need:
            if not self._evict_prefix_page():
                return None
        pages = [self._free_pages.pop() for _ in range(need)]
        for j, p in enumerate(pages):
            self._page_table[slot_i, first_index + j] = p
        self._kv_pages_touched.update(pages)
        self.registry.counter("serve_kv_page_allocs_total").inc(need)
        return pages

    def _ensure_page_capacity(self, slot_i: int, slot: _Slot,
                              through_pos: int = -1) -> bool:
        """Allocate-on-advance: make sure the page covering the slot's
        next write position exists (pinned prefix pages count toward
        coverage; new pages are always PRIVATE). ``through_pos`` extends
        coverage to a LATER position (a spec burst writes pos..pos+K in
        one cycle; the rejection rewind recycles the over-allocation).
        False = pool exhausted even after evicting every evictable prefix
        page."""
        need = max(slot.pos, through_pos) // self.page_tokens + 1
        while len(slot.pinned) + len(slot.pages) < need:
            if not self._free_pages and not self._evict_prefix_page():
                return False
            p = self._free_pages.pop()
            self._page_table[slot_i,
                             len(slot.pinned) + len(slot.pages)] = p
            slot.pages.append(p)
            self._kv_pages_touched.add(p)
            self.registry.counter("serve_kv_page_allocs_total").inc()
        return True

    def _release_pages(self, slot_i: int, slot: _Slot) -> None:
        """Free-on-finish with recycling: PRIVATE pages re-enter the free
        list (LIFO), prefix pins drop their refcount (the pages stay
        cached), and the table row resets to the garbage page."""
        if self._paged_kv is None:
            return
        self._free_pages.extend(slot.pages)
        slot.pages = []
        if slot.pinned:
            self._prefix.unpin(slot.pinned)
            slot.pinned = []
        self._page_table[slot_i, :] = 0
        self._update_kv_gauges()

    def _evict_prefix_page(self) -> bool:
        """Pool-pressure relief valve: LRU-evict one unpinned prefix page
        back to the free list. False when the cache is off or everything
        cached is pinned by a live slot."""
        if self._prefix is None:
            return False
        page = self._prefix.evict_one()
        if page is None:
            return False
        self._free_pages.append(page)
        return True

    @torch.inference_mode()
    def _copy_page(self, src: int, dst: int) -> None:
        """Device-copy one pool page in every layer, its scales too (COW
        at the divergence page: the private copy takes the suffix write,
        the shared source stays immutable)."""
        pt = self.page_tokens
        for t in self._cache.leaves():
            t[dst * pt:(dst + 1) * pt] = t[src * pt:(src + 1) * pt]

    def _read_page_rows(self, page: int) -> list:
        """One page's rows as host numpy arrays in ``KVCache.leaves()``
        order (the spill payload; bf16 as its int16 bits; the store
        digest guarantees the reader's pool has the same leaves)."""
        pt = self.page_tokens
        return [_host(t[page * pt:(page + 1) * pt])
                for t in self._cache.leaves()]

    def _spill_prefix_page(self, node, parent_digest: str) -> None:
        """Write-through one freshly-inserted prefix page to the shared
        store (fsatomic first-writer-wins: N replicas spilling the
        fleet-common system prefix commit it once). Best-effort — a
        read-only disk degrades to a per-replica cache."""
        if self._prefix_store is None \
                or self._prefix_store.exists(node.digest):
            return
        rows = self._read_page_rows(node.page)
        if self._prefix_store.save(node.digest, parent_digest,
                                   node.depth, rows):
            self.registry.counter("serve_prefix_spills_total").inc()

    @torch.inference_mode()
    def _warm_start_prefix(self) -> None:
        """Adopt the fleet's spilled prefix set into this replica's pool
        (depth order: a page is adopted only under its already-adopted
        parent, so a capacity- or pool-truncated load still leaves a
        prefix-closed trie). Bounded by the cache capacity AND the free
        list — warm pages are all evictable, so they can never crowd out
        the first real admission. An orphan or a foreign/torn entry is
        skipped, not fatal."""
        leaves = self._cache.leaves()
        want = [((self.page_tokens,) + tuple(t.shape[1:]),
                 _host(t[:0]).dtype) for t in leaves]
        pt = self.page_tokens
        loaded = 0
        for entry in self._prefix_store.load_all(
                limit=self._prefix.capacity):
            digest = entry.get("digest", "")
            depth = int(entry.get("depth", 0))
            rows = entry.get("rows")
            if not digest or self._prefix.get(digest) is not None:
                continue
            parent = None
            if depth > 0:
                parent = self._prefix.get(entry.get("parent", pk.ROOT))
                if parent is None or parent.depth != depth - 1:
                    continue      # orphan: its parent didn't make it
            if not isinstance(rows, list) or len(rows) != len(leaves) \
                    or any(not isinstance(r, np.ndarray)
                           or (r.shape, r.dtype) != w
                           for r, w in zip(rows, want)):
                continue          # foreign/torn entry: skip, not crash
            if self._prefix.pages_cached >= self._prefix.capacity \
                    or not self._free_pages:
                break
            page = self._free_pages.pop()
            self._kv_pages_touched.add(page)
            for t, r in zip(leaves, rows):
                t[page * pt:(page + 1) * pt] = _device(r, t)
            self._prefix.insert(digest, parent, depth, page)
            loaded += 1
        if loaded:
            self.registry.counter(
                "serve_prefix_warm_loads_total").inc(loaded)
            self._update_kv_gauges()

    def _adopt_prefix_pages(self, slot_i: int, slot: _Slot,
                            resume: np.ndarray) -> None:
        """Post-prefill insert: every full page covered by the request's
        PROMPT becomes a cached, refcounted node. A concurrent duplicate
        (two same-prefix admissions in one batch both missed lookup)
        dedups here: the private page goes back to the free list and the
        slot repoints at the cached twin (bitwise-identical contents, from
        the same deterministic prefill). When the cache is full of pinned
        pages the page stays private."""
        pt = self.page_tokens
        full = int(slot.req.prompt.size) // pt
        prev = slot.pinned[-1] if slot.pinned else None
        for j in range(len(slot.pinned), full):
            digest = pk.token_prefix_digest(resume, (j + 1) * pt)
            node = self._prefix.get(digest)
            if node is not None:
                # Duplicate: recycle our private page, share theirs.
                self._free_pages.append(slot.pages.pop(0))
                self._page_table[slot_i, j] = node.page
            else:
                while self._prefix.pages_cached >= self._prefix.capacity:
                    if not self._evict_prefix_page():
                        return     # full of pinned pages: stay private
                node = self._prefix.insert(
                    digest, prev, j, slot.pages.pop(0))
                self._spill_prefix_page(
                    node, prev.digest if prev is not None else pk.ROOT)
            self._prefix.pin([node])
            slot.pinned.append(node)
            prev = node

    def _choose_preempt_victim(self, blocked) -> int:
        """Pick the slot index to preempt from ``blocked`` [(slot_i,
        slot), ...]: the YOUNGEST admission whose resume prefill (prompt
        + generated) still fits a bucket; an unresumable one only when
        every blocked slot is unresumable."""
        largest = self.buckets[-1]
        resumable = [it for it in blocked
                     if it[1].req.prompt.size
                     + len(it[1].req.tokens) <= largest]
        pool = resumable if resumable else blocked
        return max(pool, key=lambda it: it[1].seq)[0]

    def _preempt_slot(self, slot_i: int) -> None:
        """Pool exhausted and nothing can advance: push the youngest
        blocked request back to the HEAD of the queue with its progress
        intact (on re-admission the engine re-prefills prompt + generated
        and the sample stream continues at its per-step key)."""
        slot = self._active[slot_i]
        self._active[slot_i] = None
        self._release_pages(slot_i, slot)
        req = slot.req
        req.preemptions += 1
        req._preempt_t = time.perf_counter()
        self.registry.counter("serve_kv_preemptions_total").inc()
        flightrec.record("req", f"preempt {req.id}")
        if req.trace_id:
            tracing.crumb("preempt", req.trace_id, req.trace_hop,
                          rid=req.id)
        self.queue.requeue_front([req])
        self.registry.gauge("serve_active_slots").set(
            self.active_slots())
        self.registry.gauge("serve_queue_depth").set(self.queue.depth())

    # -- public API ------------------------------------------------------

    def start(self) -> "Engine":
        # Prefix warm start BEFORE the engine thread runs: a respawned or
        # scaled-up replica adopts the fleet's spilled prefix set instead
        # of cold KV, so its very first shared-prefix request prefills
        # only the suffix.
        if self._prefix_store is not None:
            self._warm_start_prefix()
        # A decode iteration wedged on the device past the budget pages
        # thread_stalled; idle waits (empty pool) do not.
        self._thread_handle = flightrec.register_thread(
            "serve-engine", stall_after_s=120.0)
        flightrec.record("serve", f"engine start slots={self.slots}")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpunet-serve-engine")
        self._thread.start()
        return self

    @property
    def healthy(self) -> bool:
        return (self.error is None and self._thread is not None
                and self._thread.is_alive())

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def active_slots(self) -> int:
        return sum(1 for s in self._active if s is not None)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise PromptTooLongError(
            f"prompt of {prompt_len} tokens exceeds the largest "
            f"prefill bucket ({self.buckets[-1]})")

    def submit(self, prompt, **kw) -> GenerateRequest:
        """Admit a request (or raise QueueFullError / DrainingError /
        PromptTooLongError / ValueError). The generation budget is
        clamped to the operator cap and the KV length, never silently:
        ``req.requested_max_new_tokens`` keeps what the client asked for,
        ``req.max_new_tokens`` is the EFFECTIVE budget. Never blocks."""
        if self.error is not None:
            raise DrainingError(f"engine failed: {self.error}")
        kw.setdefault("max_new_tokens", self.cfg.default_max_new_tokens)
        requested = int(kw["max_new_tokens"])
        kw["max_new_tokens"] = min(requested,
                                   self.cfg.max_new_tokens_cap)
        if (kw.get("deadline_s") or 0) <= 0 \
                and self.cfg.default_deadline_s > 0:
            kw["deadline_s"] = self.cfg.default_deadline_s
        req = GenerateRequest(prompt, **kw)
        req.requested_max_new_tokens = requested
        try:
            n = int(req.prompt.size)
            # A cross-replica resume (router failover) re-prefills
            # prompt PLUS the journaled tokens: the combined length
            # must fit a bucket, like any preempt-resume.
            self.bucket_for(n + req.resume_offset)
            if n + req.max_new_tokens > self.max_seq_len:
                req.max_new_tokens = self.max_seq_len - n
                if req.max_new_tokens < 1:
                    raise PromptTooLongError(
                        f"prompt of {n} tokens leaves no room to "
                        f"generate (max_seq_len {self.max_seq_len})")
            if self._paged_kv is not None:
                # Completability guard: a request whose FULL length
                # cannot fit the page pool even alone would preempt
                # itself forever — reject it up front instead.
                worst = -(-(n + req.max_new_tokens) // self.page_tokens)
                if worst > self.kv_pages_usable:
                    raise PromptTooLongError(
                        f"request needs {worst} KV pages at full "
                        f"length but the pool has "
                        f"{self.kv_pages_usable}; lower "
                        "max_new_tokens or grow --kv-pages")
            if req.resume_offset and req.temperature > 0 \
                    and not self.device_sampling:
                # Sampled-continuation determinism rests on the device
                # sampler's counter-based (seed, step) draws; the host
                # sampler's generator would restart at draw 0.
                raise ValueError(
                    "sampled resume_tokens require device-side "
                    "sampling (counter-based per-(seed, step) keys); "
                    "this replica runs --no-device-sampling")
            if req.resume_offset and req.stop_token is not None \
                    and req.stop_token in req.tokens:
                # The journal already holds the stop token: an
                # uninterrupted run stops THERE.
                req.finish(FINISH_STOP)
                self._account_finish(req, FINISH_STOP)
                self.registry.counter("serve_requests_total").inc()
                return req
            if req.resume_offset \
                    and req.resume_offset >= req.max_new_tokens:
                # The journal already meets the (clamped) budget.
                req.finish(FINISH_LENGTH)
                self._account_finish(req, FINISH_LENGTH)
                self.registry.counter("serve_requests_total").inc()
                return req
            self.queue.submit(req)       # may raise QueueFull/Draining
        except Exception:
            self.registry.counter("serve_requests_rejected").inc()
            raise
        flightrec.record("req", f"submit {req.id} len={req.prompt.size}")
        if req.resume_offset:
            flightrec.record(
                "req", f"resume {req.id} off={req.resume_offset}")
        if req.trace_id:
            tracing.crumb("submit", req.trace_id, req.trace_hop,
                          rid=req.id)
        self.registry.counter("serve_requests_total").inc()
        self.registry.gauge("serve_queue_depth").set(self.queue.depth())
        self._wake.set()
        return req

    def _kill_survivors(self, reason: str) -> None:
        """Finish every in-flight and still-queued request with
        ``reason``, through the shared accounting. Only safe from the
        engine thread, or once it can no longer run."""
        for i, slot in enumerate(self._active):
            if slot is not None:
                self._finish_slot(i, reason)
        while True:
            reqs = self.queue.pop_ready(self.queue.queue_max)
            if not reqs:
                break
            for req in reqs:
                req.finish(reason)
                self._account_finish(req, reason)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting, let in-flight (and
        already-queued) requests finish, then stop the loop. Returns
        True when everything finished inside the timeout; leftovers are
        finished with finish_reason='drain'."""
        self._draining.set()
        waiting = self.queue.close()
        self._wake.set()
        if self._thread is None or not self._thread.is_alive():
            # Never started (or already dead): no loop can finish the
            # work — fail fast instead of waiting out the budget.
            clean = self.active_slots() == 0 and not waiting
            self._kill_survivors(FINISH_DRAIN)
            self._stop.set()
            self._drained.set()
            return clean
        budget = timeout if timeout is not None \
            else self.cfg.drain_timeout_s
        clean = self._drained.wait(budget)
        if not clean:
            # Timeout: the ENGINE finishes survivors with reason 'drain'
            # through _finish_slot, so the counters stay truthful.
            self._drain_kill.set()
            self._wake.set()
            self._drained.wait(5.0)
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        return clean

    def stop(self) -> None:
        """Hard stop (tests / error paths): every in-flight request is
        FINISHED here, so clients blocked in result()/events() unblock
        now, not at their own timeout."""
        self._draining.set()
        self.queue.fail_all("engine stopped")
        for slot in list(self._active):
            if slot is not None:
                slot.req.cancel()
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        # The loop exits at the top of its while without a final reap.
        self._kill_survivors(FINISH_CANCELLED)

    # -- engine loop -----------------------------------------------------

    def _run(self) -> None:
        handle = self._thread_handle
        try:
            while not self._stop.is_set():
                # Busy only when there is (potential) work: an empty
                # iteration is a poll, and marking it busy would lie to
                # the stall watchdog and flood the ring.
                if (self.active_slots() or self.queue.depth()
                        or self._drain_kill.is_set()):
                    handle.beat("busy")
                else:
                    handle.beat("idle")
                did_work = self._iterate()
                if self._draining.is_set() and self.active_slots() == 0 \
                        and self.queue.depth() == 0:
                    break
                if not did_work:
                    handle.beat("idle")
                    self._wake.wait(timeout=0.02)
                    self._wake.clear()
            handle.beat("idle")
            self._emit_record(final=True)
        except Exception as e:  # noqa: BLE001 — engine death is a
            # liveness event: surface it through /healthz and fail every
            # request fast rather than hanging clients; the loop ends.
            self.error = f"{type(e).__name__}: {e}"
            flightrec.record("serve", f"engine error: {e}")
            for slot in self._active:
                if slot is not None:
                    slot.req.finish(FINISH_ERROR, error=self.error)
            self._active = [None] * self.slots
            self.queue.fail_all(self.error)
            # A dead loop is not a stalled one (/healthz reports it): a
            # handle left busy would page thread_stalled to any
            # watchdog in this process for good.
            handle.beat("idle")
        finally:
            self._drained.set()

    def _iterate(self) -> bool:
        """One engine iteration: reap -> admit(prefill) -> decode.
        Returns False when there was nothing to do (caller sleeps)."""
        if self._drain_kill.is_set():
            # Drain timeout expired: the shutdown took the survivors.
            self._kill_survivors(FINISH_DRAIN)
            return False
        if self.chaos is not None:
            self.chaos.maybe_stall()    # wedged-replica injection
        self._reap()
        admitted = self._admit()
        stepped = self._decode_iteration()
        now = time.perf_counter()
        if self.cfg.emit_every_s > 0 \
                and now - self._last_emit >= self.cfg.emit_every_s:
            self._emit_record()
        return admitted or stepped

    def _reap(self) -> None:
        """Free slots whose request was cancelled or hit its deadline
        (cooperative cancellation point)."""
        now = time.perf_counter()
        for i, slot in enumerate(self._active):
            if slot is None:
                continue
            if slot.req.cancelled:
                self._finish_slot(i, FINISH_CANCELLED)
            elif slot.req.expired(now):
                self._finish_slot(i, FINISH_DEADLINE)

    def _account_finish(self, req, reason: str) -> None:
        """Finish accounting shared by slot-finishes and requests the
        QUEUE finishes before they reach a slot: the counters reconcile
        (requests_total == rejected + sum(finished_*))."""
        reg = self.registry
        flightrec.record("req", f"finish {req.id} {reason}")
        reg.counter(f"serve_finished_{reason}").inc()
        if reason in (FINISH_LENGTH, FINISH_STOP):
            reg.counter("serve_requests_completed").inc()
        if req.e2e_s is not None:
            reg.histogram("serve_e2e_s").observe(req.e2e_s)
        if req.trace_id:
            # Close this hop's replica span: crumb for the timeline
            # join, one obs_trace record with the phase decomposition.
            tracing.crumb("finish", req.trace_id, req.trace_hop,
                          rid=req.id, reason=reason)
            record = tracing.build_trace_record(
                trace_id=req.trace_id, hop=req.trace_hop,
                role="replica", finish_reason=reason,
                queue_s=req.queue_s, prefill_s=req.prefill_s,
                prefill_bucket=req.prefill_bucket,
                first_decode_s=req.first_decode_s,
                tokens=len(req.tokens) - req.resume_offset,
                preemptions=req.preemptions,
                preempt_wall_s=req.preempt_wall_s or None,
                resume_offset=req.resume_offset,
                ttft_s=req.ttft_s, e2e_s=req.e2e_s,
                error=req.error or "")
            tracing.observe_trace(reg, record)
            reg.emit("obs_trace", record)

    def _finish_slot(self, i: int, reason: str) -> None:
        slot = self._active[i]
        self._active[i] = None
        self._release_pages(i, slot)
        slot.req.finish(reason)
        self._account_finish(slot.req, reason)
        self.registry.gauge("serve_active_slots").set(self.active_slots())

    def _admit(self) -> bool:
        """Admit waiting requests into free slots and prefill them,
        grouped by bucket so each group is one device call. Paged KV:
        admission is FIFO and all-or-nothing per request — when the pool
        cannot cover the next request's prompt, it (and everyone behind
        it) goes back to the queue head until pages free up."""
        free = [i for i, s in enumerate(self._active) if s is None]
        if not free:
            return False
        reqs = self.queue.pop_ready(len(free))
        self.registry.gauge("serve_queue_depth").set(self.queue.depth())
        if not reqs:
            return False
        if self._thread_handle is not None:
            # A request can land between the idle beat and this pop:
            # busy BEFORE the prefill device call, so a wedged call
            # trips the stall watchdog.
            self._thread_handle.beat("busy")
        admitted = []    # (slot_i, bucket, req, resume, pages, start,
        #                   pinned)
        pending = collections.deque(reqs)
        free_iter = iter(free)
        slot_i = next(free_iter, None)
        while pending and slot_i is not None:
            req = pending[0]
            # Resume-prefill for preempted requests: re-embed the prompt
            # PLUS everything already generated.
            if req.tokens:
                resume = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)])
            else:
                resume = req.prompt
            n = int(resume.size)
            try:
                # Conservative full-length fit (cache hits are never
                # guaranteed).
                bucket = self.bucket_for(n)
            except PromptTooLongError as e:
                # A resumed request can outgrow the largest bucket; fail
                # it loudly rather than wedge the queue head.
                pending.popleft()
                req.finish(FINISH_ERROR, error=f"preempt-resume: {e}")
                self._account_finish(req, FINISH_ERROR)
                continue
            start = 0
            pinned: List = []
            if self._paged_kv is not None:
                cow_src = None
                if self._prefix is not None:
                    # Pin cap (n-1)//page_tokens: at least one suffix
                    # token is always re-prefilled — the logits at
                    # position n-1 come from compute, never from cached
                    # K/V.
                    pinned = self._prefix.lookup(
                        resume, (n - 1) // self.page_tokens)
                    start = len(pinned) * self.page_tokens
                    if n % self.page_tokens == 0 and pinned \
                            and start == n - self.page_tokens:
                        # Full page-aligned match: the divergence page is
                        # cached too. COW it instead of re-prefilling it.
                        cow_src = self._prefix.get(
                            pk.token_prefix_digest(resume, n))
                    # Pin BEFORE allocating: allocation may evict
                    # unpinned cache pages.
                    if cow_src is not None:
                        self._prefix.pin(pinned + [cow_src])
                    elif pinned:
                        self._prefix.pin(pinned)
                pages = self._alloc_pages_for(slot_i, n,
                                              first_index=len(pinned))
                if pages is None:
                    if cow_src is not None:
                        self._prefix.unpin(pinned + [cow_src])
                    elif pinned:
                        self._prefix.unpin(pinned)
                    break            # pool pressure: FIFO order holds
                # Map the pinned prefix pages into the slot's table
                # (indices 0..k-1); nothing ever writes them.
                for j, node in enumerate(pinned):
                    self._page_table[slot_i, j] = node.page
                if cow_src is not None:
                    # Copy-on-write at the divergence page, then prefill
                    # only the final token (which overwrites its own row
                    # in the copy; the shared page stays immutable).
                    self._copy_page(cow_src.page, pages[0])
                    self._prefix.unpin([cow_src])
                    start = n - 1
                    self.registry.counter("serve_prefix_cow_total").inc()
            else:
                pages = []
            pending.popleft()
            if start:
                # The suffix picks the bucket.
                bucket = self.bucket_for(n - start)
            admitted.append((slot_i, bucket, req, resume, pages, start,
                             pinned))
            slot_i = next(free_iter, None)
        if pending:
            self.queue.requeue_front(pending)
            self.registry.gauge("serve_queue_depth").set(
                self.queue.depth())
        if not admitted:
            return False
        by_bucket = {}
        for slot_i, bucket, req, resume, pages, start, pinned \
                in admitted:
            by_bucket.setdefault(bucket, []).append(
                (slot_i, req, resume, pages, start, pinned))
        for bucket, group in sorted(by_bucket.items()):
            self._prefill(bucket, group)
        if self._drafter is not None:
            # The drafter re-embeds the FULL prompt (prefix hits
            # included), so the grouping key is the full-length bucket,
            # not the suffix bucket the main prefill used.
            draft_groups: dict = {}
            for slot_i, _, _, resume, _, _, _ in admitted:
                if self._active[slot_i] is None:
                    continue     # finished inside its own prefill
                draft_groups.setdefault(
                    self.bucket_for(int(resume.size)), []).append(
                        (slot_i, resume))
            for bucket, rows in sorted(draft_groups.items()):
                self._draft_prefill(bucket, rows)
        self._update_kv_gauges()
        self.registry.gauge("serve_active_slots").set(self.active_slots())
        return True

    def _prefill(self, bucket: int, group) -> None:
        """One chunked-prefill device call for every admitted request
        padded to this bucket; K/V land in each slot's cache rows (or
        pages) and the next token is sampled from the last REAL position.
        The padded tail writes garbage K/V beyond the prompt — masked
        invariant: a decode query at position p attends only j <= p and
        overwrites position p first, so padding is never visible.
        ``group`` rows are ``(slot_i, req, resume_tokens, pages, start,
        pinned)``; ``start`` is the first position NOT covered by pinned
        prefix-cache pages — only ``resume[start:]`` is embedded, at
        ``positions = start``, so no write touches a pinned page."""
        t0 = time.perf_counter()
        toks = np.zeros((self.slots, bucket), np.int64)
        active = np.zeros((self.slots,), bool)
        last_idx = np.zeros((self.slots,), np.int64)
        positions = np.zeros((self.slots,), np.int64)
        for slot_i, req, resume, pages, start, pinned in group:
            n = int(resume.size)
            toks[slot_i, :n - start] = resume[start:]
            active[slot_i] = True
            last_idx[slot_i] = n - start - 1
            positions[slot_i] = start
            # Slot the request BEFORE the device call: if the step
            # raises, the failure handler finds (and fails) it.
            self._admit_seq += 1
            slot = _Slot(req, pos=n, next_token=0,
                         generated=len(req.tokens) + 1,
                         seq=self._admit_seq)
            slot.pages = pages
            slot.pinned = pinned
            self._active[slot_i] = slot
        for _, req, resume, _, start, _ in group:
            if int(resume.size) > int(req.prompt.size):
                flightrec.record("req", f"resume_prefill {req.id}")
            else:
                flightrec.record("req", f"prefill {req.id}")
            if start:
                flightrec.record(
                    "req", f"prefix_hit {req.id} tokens={start}")
            if req.prefill_start_t is None:
                req.prefill_start_t = t0
                req.prefill_bucket = bucket
            if req._preempt_t is not None:
                req.preempt_wall_s += t0 - req._preempt_t
                req._preempt_t = None
            if req.trace_id:
                tracing.crumb("prefill", req.trace_id, req.trace_hop,
                              rid=req.id, b=bucket)
        if self.chaos is not None:
            self.chaos.on_prefill()     # kill@prefill injection point
        with _ring_span("tpunet/serve_prefill"):
            out = self._step(toks, positions, active, last_idx)
        reg = self.registry
        # Adopt freshly-written full prompt pages into the prefix cache
        # BEFORE the finish checks below can release a request's pages.
        if self._prefix is not None:
            for slot_i, req, resume, pages, start, pinned in group:
                slot = self._active[slot_i]
                if slot is not None:
                    self._adopt_prefix_pages(slot_i, slot, resume)
            self._update_kv_gauges()
        prefill_done = time.perf_counter()
        for slot_i, req, resume, _, start, _ in group:
            if req.prefill_done_t is None:
                req.prefill_done_t = prefill_done
            if self.device_sampling:
                first = int(out[slot_i])
            else:
                first = sample_token(out[slot_i], req)
            fresh = req.first_token_t is None
            self._active[slot_i].next_token = first
            req.push_token(first)
            if fresh:
                flightrec.record("req", f"first_token {req.id}")
                if req.trace_id:
                    tracing.crumb("first_token", req.trace_id,
                                  req.trace_hop, rid=req.id)
                reg.histogram("serve_ttft_s").observe(req.ttft_s)
            reg.counter("serve_tokens_total").inc()
            if self.chaos is not None:
                self.chaos.on_token()   # kill/stall@tokens (post-push:
                #                         the token reached the stream)
            self._slot_maybe_finish(slot_i, first)
        reg.counter("serve_prefills_total").inc()
        # Suffix tokens only: with a prefix hit this is the REAL prefill
        # compute.
        reg.counter("serve_prefill_tokens_total").inc(
            sum(int(r.size) - st for _, _, r, _, st, _ in group))
        reg.histogram("serve_prefill_s").observe(
            time.perf_counter() - t0)

    def _draft_prefill(self, bucket: int, rows) -> None:
        """Prefill the DRAFTER's paged pool for freshly admitted slots:
        one write-only full-prompt pass a bucket. ``rows`` are
        ``(slot_i, resume_tokens)``.

        The drafter always embeds the FULL prompt from position 0, even
        when the main prefill rode a prefix-cache hit. Pinned prefix page
        ids are shared across slots and the drafter pool mirrors the main
        page table verbatim, so a drafter write to a shared page id is an
        idempotent rewrite: every slot pinning that page holds the same
        token prefix and the drafter is deterministic. Re-deriving
        instead of caching drafter pages keeps the drafter pool warm with
        no extra allocator state and no drafter-side COW; the cost is one
        drafter-width full prefill an admission."""
        toks = np.zeros((self.slots, bucket), np.int64)
        active = np.zeros((self.slots,), bool)
        positions = np.zeros((self.slots,), np.int64)
        for slot_i, resume in rows:
            toks[slot_i, :int(resume.size)] = resume
            active[slot_i] = True
        with _ring_span("tpunet/serve_spec_prefill"):
            self._draft_prefill_step(toks, positions, active)

    def _slot_maybe_finish(self, slot_i: int, token: int) -> bool:
        """Stop checks after a sampled token; True when the slot was
        freed."""
        slot = self._active[slot_i]
        req = slot.req
        if req.stop_token is not None and token == req.stop_token:
            self._finish_slot(slot_i, FINISH_STOP)
            return True
        if slot.generated >= req.max_new_tokens \
                or slot.pos + 1 > self.max_seq_len:
            self._finish_slot(slot_i, FINISH_LENGTH)
            return True
        return False

    def _decode_iteration(self) -> bool:
        """One masked decode step across the whole pool: every active
        slot consumes its pending token at its own position and samples
        the next one. Paged KV: each slot's next write page is allocated
        here (allocate-on-advance); a slot the pool cannot extend sits
        the iteration out, and when NOTHING can advance the youngest
        blocked slot is preempted back to the queue."""
        if self._drafter is not None:
            return self._spec_decode_iteration()
        live = [(i, s) for i, s in enumerate(self._active)
                if s is not None]
        if not live:
            return False
        if self._paged_kv is not None:
            ready = []
            blocked = []
            for i, slot in live:
                if self._ensure_page_capacity(i, slot):
                    ready.append((i, slot))
                else:
                    blocked.append((i, slot))
            if blocked and not ready:
                self._preempt_slot(self._choose_preempt_victim(blocked))
                return True          # freed pages; retry next iteration
            self._update_kv_gauges()
            live = ready
            if not live:
                return False
        self._decode_width1(live)
        return True

    def _decode_width1(self, live) -> None:
        """One [slots, 1] masked decode call for ``live`` slots (page
        capacity already ensured by the caller). Shared by the normal
        path and the spec path's tail fallback."""
        t0 = time.perf_counter()
        toks = np.zeros((self.slots, 1), np.int64)
        positions = np.zeros((self.slots,), np.int64)
        active = np.zeros((self.slots,), bool)
        for i, slot in live:
            toks[i, 0] = slot.next_token
            positions[i] = slot.pos
            active[i] = True
        with _ring_span("tpunet/serve_decode"):
            out = self._step(toks, positions, active,
                             np.zeros((self.slots,), np.int64))
        lap = time.perf_counter() - t0
        reg = self.registry
        reg.counter("serve_decode_steps_total").inc()
        reg.histogram("serve_decode_iter_s").observe(lap)
        # per-token latency: the iteration produced one token for each
        # live slot, each of which waited the full iteration.
        reg.histogram("serve_token_s").observe(lap)
        for i, slot in live:
            if self.device_sampling:
                nxt = int(out[i])
            else:
                nxt = sample_token(out[i], slot.req)
            slot.pos += 1
            slot.next_token = nxt
            slot.generated += 1
            slot.req.push_token(nxt)
            reg.counter("serve_tokens_total").inc()
            if self.chaos is not None:
                self.chaos.on_token()   # kill/stall@tokens (post-push)
            self._slot_maybe_finish(i, nxt)

    # -- speculative decode path ------------------------------------------

    def _spec_decode_iteration(self) -> bool:
        """One draft+verify cycle across the pool: burst-eligible slots
        draft K tokens and verify them in one wide call (1..K+1 verified
        tokens each); tail slots — too close to max_seq_len for a full
        burst — take the width-1 call in the same iteration. A slot near
        its TOKEN budget still bursts: the emit loop stops exactly at
        max_new_tokens (the overshot verify positions are wasted compute,
        and the slot releases its pages on finish). POOL PRESSURE can
        also force a width-1 cycle; such a slot may re-enter the burst
        later with a drafter-pool gap at the width-1 positions, which
        costs acceptance (bad drafts), never correctness: every emitted
        token comes from the verify (or width-1) call, and a rejection
        still yields one verified token a cycle.

        tpunet slices the page table to per-page window buckets here,
        to bound its compiled program shapes; the port attends a row's
        whole table, as its decode step does, so it needs none."""
        live = [(i, s) for i, s in enumerate(self._active)
                if s is not None]
        if not live:
            return False
        k = self.spec_k
        burst, seq_ready, blocked = [], [], []
        for i, slot in live:
            eligible = slot.pos + k + 1 <= self.max_seq_len
            # A burst writes pos..pos+K (both pools; shared table):
            # ensure coverage through pos+K, or fall back to width-1
            # coverage before counting the slot as blocked.
            if eligible and self._ensure_page_capacity(
                    i, slot, through_pos=slot.pos + k):
                burst.append((i, slot))
            elif self._ensure_page_capacity(i, slot):
                seq_ready.append((i, slot))
            else:
                blocked.append((i, slot))
        if blocked and not burst and not seq_ready:
            self._preempt_slot(self._choose_preempt_victim(blocked))
            return True              # freed pages; retry next iteration
        self._update_kv_gauges()
        if not burst and not seq_ready:
            return False
        if burst:
            self._spec_burst(burst)
        if seq_ready:
            # Their drafter pool now lags the main cursor — benign, as
            # the docstring argues.
            self._decode_width1([(i, s) for i, s in seq_ready
                                 if self._active[i] is s])
        return True

    def _spec_burst(self, burst) -> None:
        """Draft K+1, verify K+1, accept, rewind — the spec hot path.
        Acceptance (``spec.accept_drafts``) keeps the longest prefix where
        draft d_j matched verify choice c_{j-1}; the slot emits c_0..c_a
        (ALL from the verify, which is why the stream equals spec-off's),
        advances its cursor by a+1, and the rejected tail pages go back
        to the free list. A slot that stops or is preempted resumes from
        these verified tokens only."""
        k = self.spec_k
        reg = self.registry
        t0 = time.perf_counter()
        first = np.zeros((self.slots,), np.int64)
        positions = np.zeros((self.slots,), np.int64)
        active = np.zeros((self.slots,), bool)
        for i, slot in burst:
            first[i] = slot.next_token
            positions[i] = slot.pos
            active[i] = True
        with _ring_span("tpunet/serve_spec_draft"):
            drafts = self._draft_burst_step(first, positions, active)
        verify_toks = np.concatenate([first[:, None], drafts], axis=1)
        with _ring_span("tpunet/serve_spec_verify"):
            choices = self._verify_step(verify_toks, positions, active)
        lap = time.perf_counter() - t0
        reg.counter("serve_decode_steps_total").inc()
        reg.histogram("serve_decode_iter_s").observe(lap)
        reg.histogram("serve_token_s").observe(lap)
        rows = np.asarray([i for i, _ in burst])
        accepted = serve_spec.accept_drafts(drafts[rows], choices[rows])
        for (i, slot), a in zip(burst, accepted):
            a = int(a)
            reg.counter("serve_spec_draft_tokens_total").inc(k)
            reg.counter("serve_spec_accepted_tokens_total").inc(a)
            reg.counter("serve_spec_rejected_tokens_total").inc(k - a)
            reg.counter("serve_spec_verify_steps_total").inc()
            finished = False
            for j in range(a + 1):
                tok = int(choices[i, j])
                slot.pos += 1
                slot.generated += 1
                slot.next_token = tok
                slot.req.push_token(tok)
                reg.counter("serve_tokens_total").inc()
                if self.chaos is not None:
                    self.chaos.on_token()   # post-push: only VERIFIED
                    #                         tokens reach the stream
                if self._slot_maybe_finish(i, tok):
                    finished = True
                    break
            if not finished:
                self._rewind_slot_pages(i, slot)
        drafted = reg.counter("serve_spec_draft_tokens_total").value
        acc = reg.counter("serve_spec_accepted_tokens_total").value
        reg.gauge("serve_spec_acceptance_rate").set(
            round(acc / drafted, 4) if drafted else 0.0)
        self._update_kv_gauges()

    def _rewind_slot_pages(self, slot_i: int, slot: _Slot) -> None:
        """Cursor rewind after a (partial) rejection: free the private
        tail pages beyond the last verified position. The rows holding
        rejected K/V are simply recycled — the masked write-then-read
        invariant makes stale rows invisible, so the rewind is host
        bookkeeping only. It stops at pinned prefix pages: a burst writes
        only positions >= the prefill suffix start, which live on PRIVATE
        pages, and only ``slot.pages`` (the private list) is ever freed,
        so neither a shared prefix page nor the drafter pool's mirror of
        it (the same page id) is ever rewound."""
        keep_hi = (slot.pos - 1) // self.page_tokens
        keep_private = max(0, keep_hi + 1 - len(slot.pinned))
        tail = slot.pages[keep_private:]
        if not tail:
            return
        del slot.pages[keep_private:]
        base = len(slot.pinned) + keep_private
        self._page_table[slot_i, base:base + len(tail)] = 0
        # reversed(): the page covering the NEXT write position goes back
        # on top of the LIFO free list, so the very next allocate-on-
        # advance hands the same page straight back.
        self._free_pages.extend(reversed(tail))

    # -- obs -------------------------------------------------------------

    def _emit_record(self, final: bool = False) -> None:
        """One ``obs_serve`` record (docs/metrics_schema.md) per window:
        cumulative counters + window histograms, then a fresh window."""
        reg = self.registry
        now = time.perf_counter()
        window = now - self._last_emit
        self._last_emit = now
        record = build_serve_record(
            reg, queue_depth=self.queue.depth(),
            active_slots=self.active_slots(), slots=self.slots,
            uptime_s=now - self._started, window_s=window, final=final)
        if self.chaos is not None:
            # A record from a chaos-armed replica says so: comparisons
            # must never mistake injected faults for regressions.
            record["chaos"] = self.chaos.render()
        # Host-thread gauges ride the serve registry too.
        THREADS.export_gauges(reg)
        reg.emit("obs_serve", record)
        reg.reset_window()
