"""LLMEngine: device-state owner and bucketed step dispatcher (PyTorch).

The host logic is the JAX package's (``serving_tpu/engine.py``) verbatim:
``TaskState``, the bucket tables, ``build_plan``, the packed-plan layout,
multi-step decode blocks with device-fed tokens and device-resident
continuation, the ``fetch_plan_result`` reorder, ``padded_prefill_tokens``
and ``prompt_row_cap``. The device parts are PyTorch's own:

- one runner per program key ``(n_steps, feed, bd, bp, qp, kvp, greedy,
  cont)``, the JAX package's one jitted program per bucket. On the CPU it
  runs eagerly; on cuda its first visit runs eagerly (the warm-up: kernel
  libraries, cuBLAS handles), its second captures it as one CUDA graph,
  and every later visit replays that graph (:class:`_Runner`). All of an
  engine's graphs share one memory pool, so together they hold about the
  largest one's working set,
- the KV cache (with its bf16 scale rows under int8 KV) and the penalty
  count map are preallocated once and every step updates them in place
  (the JAX package donates them instead); none is reallocated after a
  capture,
- the plan goes down as one packed int32 buffer, copied from pinned
  memory without blocking, and the sampled tokens come back the same way
  into pinned host buffers behind a CUDA event that
  :meth:`fetch_plan_result` waits on,
- each dispatch's random numbers come from a ``torch.Generator`` seeded
  from (seed, dispatch), drawn for the whole block before it runs, where
  the JAX package folds the dispatch and step into its PRNG key.

``validate_bucket_grid`` and ``prewarm`` are the JAX package's decisions
over the port's own warm-up of a key: its eager visit and, on cuda, its
capture, on an all-padding plan that writes only the trash page and the
count map's trash row (restored after). A key fails when the warm-up
runs out of device memory or its capture takes the engine's graphs past
``graph_budget_bytes``. Once the grid is validated nothing is captured
while serving: a key that validation did not warm up (a mixed step
beside a smaller decode bucket, a host-fed block) runs eagerly. Without
validation a key is captured at its second visit. The manifest
and AOT functions are not ported: CUDA graphs take their place.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import GeneratorConfig, ModelConfig, ResourceConfig
from .models import llama
from .ops import kernels
from .ops import kv_cache as kv_ops
from .ops import sampling as sampling_ops
from .ops.kv_cache import CacheSpec

logger = logging.getLogger("ppl.llm.serving_tpu_torch.engine")


@dataclasses.dataclass
class TaskState:
    """Host-side per-request state (reference ``TidData``,
    ``llm_generator.h:79-103``)."""

    tid: int
    temperature: float = 1.0
    top_p: float = 0.0
    top_k: int = 1
    do_sample: bool = False
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    early_stopping: bool = True
    is_token_in_out: bool = False
    stop_tokens: Optional[set] = None

    rest_iters: int = 0
    total_len: int = 0
    next_tokens: List[int] = dataclasses.field(default_factory=list)
    # chunked prefill: prompt tokens not yet fed (the sampled token of a
    # non-final chunk is discarded and the next chunk is fed instead)
    pending_prefill: List[int] = dataclasses.field(default_factory=list)
    start_pos: int = 0
    steps: int = 0
    gen_tokens_cnt: int = 0

    # resources
    cache_index: int = -1           # linear mode
    page_list: List[int] = dataclasses.field(default_factory=list)
    hash_list: List[int] = dataclasses.field(default_factory=list)
    cache_hit_count: int = 0
    slot_index: int = -1            # penalty slot


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


_PREFILL_ROW_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)


class _Runner:
    """One program key's block ``fn(packed, advance, prev_tokens, gumbel)
    -> (tokens [N, B], logprobs [N, B])``.

    On the CPU every visit runs ``fn`` eagerly. On cuda the first visit
    runs it eagerly; the second captures it into a CUDA graph over static
    copies of its inputs (unless :meth:`capture` already did, or ``lazy``
    is off: then only :meth:`capture` does) and replays it; later visits
    copy their inputs into those buffers and replay. A block runs once
    per visit: capture records without executing (the penalty count map's
    scatter-add is not idempotent). A capture failure raises.

    The kernel wrappers' checks and launch counters run only while the
    graph is captured, so the capture's launches are taken back off the
    counters and every replay adds them again. The returned tensors are
    the graph's static outputs, which the next replay overwrites: the
    caller copies them out before it dispatches again.

    ``pool``: a graph memory pool shared with other runners (None: a
    private one). ``pool_bytes`` is what the capture added to the
    allocator's reserved device memory, measured with the allocator's
    cached free blocks released first; the pool holds it while any of
    its graphs lives.
    """

    def __init__(self, fn, device: torch.device, pool=None,
                 lazy: bool = True):
        self.fn = fn
        self.device = device
        self.pool = pool
        self.lazy = lazy
        self.visits = 0
        self.replays = 0
        self.graph = None
        self.static_in: List[Optional[torch.Tensor]] = []
        self.static_out: Tuple[torch.Tensor, ...] = ()
        self.launches: Dict[str, int] = {}
        self.pool_bytes = 0

    def __call__(self, *args):
        self.visits += 1
        if self.graph is None:
            if (self.device.type != "cuda" or self.visits == 1
                    or not self.lazy):
                return self.fn(*args)
            self.capture(args)
        for dst, src in zip(self.static_in, args):
            if dst is not None:
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        self.replays += 1
        return self.static_out

    def capture(self, args) -> None:
        """Capture ``fn`` over static copies of ``args`` without running
        it (cuda only)."""
        self.static_in = [None if a is None else a.clone() for a in args]
        before = kernels.launch_counts()
        # torch.cuda.graph releases the cached blocks itself before it
        # captures; release them first so that the growth is the graph's
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = self.fn(*self.static_in)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        kernels.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph, self.static_out = graph, out
        logger.info("captured a CUDA graph, launches per replay %s; its "
                    "pool grew %d MiB; peak device memory %d MiB",
                    {k: n for k, n in self.launches.items() if n},
                    self.pool_bytes >> 20,
                    torch.cuda.max_memory_allocated(self.device) >> 20)


class LLMEngine:
    """Owns device state and runs one continuous-batching step.

    ``graph_budget_bytes``: what the engine's CUDA graphs may hold in all
    (0: no limit but the device's memory); a capture that takes them past
    it fails its key in :meth:`prewarm`."""

    def __init__(self, model_cfg: ModelConfig, resource_cfg: ResourceConfig,
                 params: Dict[str, Any], spec: CacheSpec,
                 enable_penalty: bool = False,
                 max_batch_slots: int = 0,
                 device="cuda",
                 rng_seed: int = 0,
                 graph_budget_bytes: int = 0):
        self.model_cfg = model_cfg
        self.resource_cfg = resource_cfg
        self.spec = spec
        self.enable_penalty = enable_penalty
        self.device = torch.device(device)
        self._params = params
        self._seed = rng_seed
        self._step_counter = 0

        self.kv_cache, self.kv_scale = kv_ops.init_cache(spec, self.device)
        if enable_penalty:
            self.count_map = sampling_ops.init_count_map(
                max_batch_slots, model_cfg.vocab_size, self.device)
        else:
            self.count_map = torch.zeros((1, 1), dtype=torch.int32,
                                         device=self.device)
        self.top_k_cap = resource_cfg.sampling_top_k_cap
        self._runners: Dict[Tuple, _Runner] = {}
        # One memory pool for every capture of this engine. PyTorch lets
        # graphs share a pool when they never replay at the same time and
        # no graph's static outputs are read after another graph of the
        # pool has replayed: a later capture may place its outputs in
        # blocks that an earlier graph uses as scratch. Both hold here.
        # Every replay is enqueued on one stream, and each reader of a
        # static output enqueues its read right behind the replay that
        # wrote it, before anything can dispatch again: _run copies the
        # tokens and logprobs into fresh pinned host buffers
        # (fetch_plan_result reads those) and clones the last step's
        # tokens into a fresh device tensor, which is what
        # _last_final_tokens, the fed tokens of the next dispatch and
        # dispatch_continuation's last_dev hold; the static inputs are
        # clones made before the capture, outside the pool.
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self.graph_budget_bytes = graph_budget_bytes
        self._dropped_pool_bytes = 0   # captures of keys that failed
        # a key is captured at its second visit until the grid is
        # validated; after, only the keys validation warmed up are graphs
        # and any other key stays eager, so nothing is captured while
        # serving
        self._lazy_capture = True
        # peak reserved device memory above the start of the last
        # validate_bucket_grid (graphs and the eager warm-up visits)
        self.validation_peak_bytes = 0
        self._multi_step = max(1, resource_cfg.multi_step)
        self._block_tail = resource_cfg.block_tail
        # device [B_bucket] sampled tokens of the last dispatch's last
        # step: the tokens a device-fed block starts from
        self._last_final_tokens: Optional[torch.Tensor] = None
        self._last_handle: Optional[Dict[str, Any]] = None
        # dispatches by kind: host-fed plans, device-fed plans, and
        # continuations of a device-resident plan
        self.dispatch_counts = {"plan": 0, "fed": 0, "continuation": 0}
        self._trace = None
        self._trace_dir = ""

        self.batch_buckets = tuple(resource_cfg.batch_buckets)
        self.token_buckets = tuple(resource_cfg.token_buckets)
        # per-token-bucket prefill row caps, from validate_bucket_grid
        self.max_prefill_rows: Dict[int, int] = {}
        self.max_kv_pages = max(
            1, -(-GeneratorConfig().max_total_tokens_per_request
                 // spec.page_size))

    # -- bucketing -----------------------------------------------------------

    # The per-step metadata arrays ride ONE packed i32 buffer (one
    # host->device copy per step) and are unpacked on the device.
    _PACK_FIELDS = (
        ("decode_tokens", "i32"), ("decode_pos", "i32"),
        ("prefill_tokens", "i32"), ("prefill_start", "i32"),
        ("prefill_len", "i32"), ("page_table", "i32"),
        ("context_len", "i32"), ("batch_slots", "i32"),
        ("temperature", "f32"), ("top_k", "i32"), ("top_p", "f32"),
        ("do_sample", "bool"), ("rep_pen", "f32"), ("pres_pen", "f32"),
        ("freq_pen", "f32"),
    )

    @staticmethod
    def _pack_arrays(a: Dict[str, np.ndarray]) -> np.ndarray:
        parts = []
        for name, kind in LLMEngine._PACK_FIELDS:
            arr = np.ascontiguousarray(a[name])
            if kind == "f32":
                arr = arr.astype(np.float32, copy=False).view(np.int32)
            elif kind == "bool":
                arr = arr.astype(np.int32)
            else:
                arr = arr.astype(np.int32, copy=False)
            parts.append(arr.ravel())
        return np.concatenate(parts)

    @staticmethod
    def _unpack(packed: torch.Tensor,
                shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
        f = {}
        ofs = 0
        for name, kind in LLMEngine._PACK_FIELDS:
            shape = shapes[name]
            n = int(np.prod(shape))
            x = packed[ofs: ofs + n].reshape(shape)
            ofs += n
            if kind == "f32":
                x = x.view(torch.float32)
            elif kind == "bool":
                x = x != 0
            f[name] = x
        return f

    @staticmethod
    def _make_input(f: Dict[str, torch.Tensor]) -> llama.StepInput:
        return llama.StepInput(
            decode_tokens=f["decode_tokens"], decode_pos=f["decode_pos"],
            prefill_tokens=f["prefill_tokens"],
            prefill_start=f["prefill_start"],
            prefill_len=f["prefill_len"], page_table=f["page_table"],
            context_len=f["context_len"], batch_slots=f["batch_slots"],
            sampling=sampling_ops.SamplingParams(
                temperature=f["temperature"], top_k=f["top_k"],
                top_p=f["top_p"], do_sample=f["do_sample"],
                repetition_penalty=f["rep_pen"],
                presence_penalty=f["pres_pen"],
                frequency_penalty=f["freq_pen"]))

    def _get_runner(self, n_steps: int, feed: bool, bd: int, bp: int,
                    qp: int, kvp: int, greedy: bool = False,
                    cont: bool = False) -> _Runner:
        """The runner of one program key (the JAX package's
        ``_get_packed_runner``). ``feed``: the decode tokens are the
        previous dispatch's last sampled tokens, on the device. ``cont``:
        a continuation re-runs a device-resident packed plan with
        positions and context lengths advanced by ``advance``."""
        key = (n_steps, feed, bd, bp, qp, kvp, greedy, cont)
        runner = self._runners.get(key)
        if runner is not None:
            return runner
        kwargs = dict(enable_penalty=self.enable_penalty,
                      quant_method=self.resource_cfg.quant_method,
                      top_k_cap=self.top_k_cap, greedy_only=greedy)
        if n_steps > 1:
            inner = llama.make_multi_step_fn(
                self.model_cfg, self.spec, n_steps,
                block_tail=self._block_tail, **kwargs)
        else:
            step = llama.make_step_fn(self.model_cfg, self.spec, **kwargs)

            def inner(params, kv_cache, kv_scale, count_map, inp, gumbel):
                out = step(params, kv_cache, kv_scale, count_map, inp,
                           None if gumbel is None else gumbel[0])
                return out.tokens[None], out.logprobs[None]
        b = bd + bp
        shapes = {
            "decode_tokens": (bd,), "decode_pos": (bd,),
            "prefill_tokens": (bp, qp), "prefill_start": (bp,),
            "prefill_len": (bp,), "page_table": (b, kvp),
            "context_len": (b,), "batch_slots": (b,),
            "temperature": (b,), "top_k": (b,), "top_p": (b,),
            "do_sample": (b,), "rep_pen": (b,), "pres_pen": (b,),
            "freq_pen": (b,),
        }

        # the block holds the device state itself, not the engine (no
        # reference cycle: a dropped engine frees its graphs and pools)
        state = (self._params, self.kv_cache, self.kv_scale, self.count_map)

        def block(packed, advance, prev_tokens, gumbel):
            f = LLMEngine._unpack(packed, shapes)
            if cont:
                f["decode_pos"] = f["decode_pos"] + advance
                f["context_len"] = f["context_len"] + advance
            if feed:
                f["decode_tokens"] = prev_tokens
            return inner(*state, LLMEngine._make_input(f), gumbel)

        runner = _Runner(block, self.device, self._graph_pool,
                         lazy=self._lazy_capture)
        self._runners[key] = runner
        return runner

    def graph_stats(self) -> Dict[str, int]:
        """Captured CUDA graphs, their replays so far, and the bytes their
        shared memory pool holds (what the captures added to the
        allocator's reserved memory, a failed key's included: the pool
        keeps it), which :meth:`prewarm` holds to ``graph_budget_bytes``."""
        runners = self._runners.values()
        return {"graphs": sum(r.graph is not None for r in runners),
                "replays": sum(r.replays for r in runners),
                "pool_bytes": (sum(r.pool_bytes for r in runners)
                               + self._dropped_pool_bytes)}

    # -- startup validation --------------------------------------------------

    def _padding_args(self, key: Tuple) -> Tuple:
        """A runner's arguments for an all-padding plan of ``key``: rows
        with context 0, page-table entries at the trash page, the trash
        penalty slot; zero noise for a sampled key."""
        n_steps, feed, bd, bp, qp, kvp, greedy, cont = key
        dev = self.device
        packed = torch.from_numpy(self._pack_arrays(
            self._plan_arrays(bd, bp, qp, kvp))).to(dev)
        advance = (torch.full((1,), n_steps, dtype=torch.int32, device=dev)
                   if cont else None)
        prev = torch.zeros(bd, dtype=torch.int32, device=dev) if feed else None
        gumbel = None
        if not greedy:
            v = self.model_cfg.vocab_size
            c = self.top_k_cap if self.top_k_cap and self.top_k_cap < v else v
            gumbel = torch.zeros((n_steps, bd + bp, c), dtype=torch.float32,
                                 device=dev)
        return packed, advance, prev, gumbel

    def _warm(self, key: Tuple) -> None:
        """Warm one key up: its eager first visit and, on cuda, its
        capture. Raises ``torch.cuda.OutOfMemoryError`` when the device
        runs out of memory."""
        runner = self._get_runner(*key[:6], greedy=key[6], cont=key[7])
        args = self._padding_args(key)
        if not runner.visits:
            runner(*args)
        if self.device.type == "cuda" and runner.graph is None:
            runner.capture(args)

    def prewarm(self, keys) -> int:
        """Warm up the step programs of ``keys`` (tuples ``(n_steps, feed,
        bd, bp, qp, kvp, greedy, cont)``) before serving, each on an
        all-padding plan; returns how many passed. A key fails when its
        warm-up runs out of device memory, or when its capture takes the
        graphs past ``graph_budget_bytes``: its runner is dropped and its
        memory released. Any other error raises. The padding writes land
        on the trash page and the count map's trash row, which are put
        back as they were."""
        trash = slice(self.spec.trash_page * self.spec.page_size,
                      (self.spec.trash_page + 1) * self.spec.page_size)
        layer_rows = [slice(li * self.spec.num_slots + trash.start,
                            li * self.spec.num_slots + trash.stop)
                      for li in range(self.spec.num_layers)]
        saved = ([self.kv_cache[:, r].clone() for r in layer_rows],
                 [None if self.kv_scale is None else self.kv_scale[r].clone()
                  for r in layer_rows],
                 self.count_map[-1].clone())
        n_ok = 0
        for key in keys:
            key = (int(key[0]), bool(key[1]), int(key[2]), int(key[3]),
                   int(key[4]), int(key[5]), bool(key[6]), bool(key[7]))
            try:
                self._warm(key)
                over = (self.graph_budget_bytes and self.graph_stats()[
                    "pool_bytes"] > self.graph_budget_bytes)
            except torch.cuda.OutOfMemoryError as e:
                logger.warning("prewarm: key %s ran out of device memory: "
                               "%s", key, str(e).splitlines()[0])
                over = True
            else:
                if over:
                    logger.warning(
                        "prewarm: key %s takes the CUDA graphs to %d MiB, "
                        "past their budget of %d MiB", key,
                        self.graph_stats()["pool_bytes"] >> 20,
                        self.graph_budget_bytes >> 20)
            if over:
                runner = self._runners.pop(key, None)
                if runner is not None:
                    self._dropped_pool_bytes += runner.pool_bytes
                del runner
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                continue
            n_ok += 1
        for r, c, sc in zip(layer_rows, saved[0], saved[1]):
            self.kv_cache[:, r] = c
            if sc is not None:
                self.kv_scale[r] = sc
        self.count_map[-1] = saved[2]
        return n_ok

    def validate_bucket_grid(self, max_total_tokens_per_request: int,
                             max_running_batch: int,
                             max_tokens_per_step: int = 0) -> int:
        """Warm up (eager visit and capture) the extreme decode- and
        mixed-prefill-bucket programs BEFORE serving and clamp the bucket
        tables to what fits device memory and the graph budget: the JAX
        package's ``validate_bucket_grid``, decision for decision, over
        :meth:`prewarm`.

        Decode buckets ascending: at each, every variant traffic can
        dispatch (greedy and sampled; for blocks, the device-fed block and
        the continuation runner); a bucket past the first one covering
        ``max_running_batch`` is dropped without a visit. With
        ``max_tokens_per_step``, per token bucket the widest mixed program
        admission can form under the padded-wave budget, next to the
        largest decode bucket: a narrower width that is the first to pass
        caps ``max_prefill_rows[qp]``, and a token bucket that fails even
        at one row gets cap 0.

        From here on, a key that this did not warm up runs eagerly.
        Returns the clamped max running batch (the largest surviving
        batch bucket, or the input if all buckets fit)."""
        self._lazy_capture = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
            reserved0 = torch.cuda.memory_reserved(self.device)
        pages_per_req = -(-max_total_tokens_per_request
                          // self.spec.page_size)
        # align the pinned production page-table width (build_plan) with
        # the shapes validated here
        self.set_max_kv_pages(pages_per_req)
        kvp = self._kvp_bucket(pages_per_req)
        n_steps = self._multi_step if self._multi_step > 1 else 1
        clamped = max_running_batch
        keep = []
        covered = False   # a kept bucket >= max_running_batch exists
        for bucket in sorted(self.batch_buckets):
            if covered:
                # unreachable at this config and unvalidated: dropped, so
                # that a validated grid never holds an unwarmed bucket
                logger.info(
                    "bucket grid: dropping unreachable (unvalidated) "
                    "decode batch bucket %d > max_running_batch %d",
                    bucket, max_running_batch)
                continue
            qp0 = self.token_buckets[0]
            keys = [(n_steps, n_steps > 1, bucket, 0, qp0, kvp, g, False)
                    for g in (False, True)]
            if n_steps > 1:
                keys += [(n_steps, True, bucket, 0, qp0, kvp, g, True)
                         for g in (False, True)]
            if all(self.prewarm([k]) == 1 for k in keys):
                keep.append(bucket)
                covered = bucket >= max_running_batch
                continue
            logger.error(
                "bucket grid: decode batch bucket %d (kvp %d) does not "
                "fit on this device - dropping it and clamping "
                "max_running_batch", bucket, kvp)
            clamped = min(clamped, max(keep) if keep else 1)
        self.batch_buckets = tuple(keep) if keep else self.batch_buckets

        if max_tokens_per_step:
            bd_max = max(self.batch_buckets)
            for qp in sorted(self.token_buckets):
                # row buckets admission can pair with this token bucket
                # under the padded-wave budget, widest first; always at
                # least try one row
                rbs = sorted((rb for rb in _PREFILL_ROW_BUCKETS
                              if rb >= 1 and rb * qp <= max_tokens_per_step),
                             reverse=True) or [1]
                if qp > max_tokens_per_step:
                    # only single-row waves can ever use this bucket
                    rbs = [1]
                for rb in rbs:
                    if all(self.prewarm(
                            [(1, False, bd_max, rb, qp, kvp, g, False)]) == 1
                           for g in (False, True)):
                        if rb != rbs[0]:
                            logger.error(
                                "bucket grid: mixed program (bd %d, qp %d, "
                                "kvp %d) only fits up to %d prefill rows - "
                                "capping the wave width for this token "
                                "bucket", bd_max, qp, kvp, rb)
                            self.max_prefill_rows[qp] = rb
                        break
                else:
                    # not even one row fits next to the largest decode
                    # bucket: admission fails such requests fast (cap 0)
                    logger.error(
                        "bucket grid: token bucket %d does not fit even at "
                        "one prefill row - prompts bucketing there will be "
                        "rejected", qp)
                    self.max_prefill_rows[qp] = 0

        if self.device.type == "cuda":
            self.validation_peak_bytes = (
                torch.cuda.max_memory_reserved(self.device) - reserved0)
        return min(clamped, max_running_batch)

    def padded_prefill_tokens(self, n_rows: int, max_chunk_len: int) -> int:
        """The PADDED prefill footprint of the plan (row bucket x token
        bucket, ``build_plan``'s bp/qp choice); a huge sentinel when the
        token bucket's row width is capped below the wave."""
        if n_rows <= 0:
            return 0
        qp = _bucket(max_chunk_len, self.token_buckets)
        rb = _bucket(n_rows, _PREFILL_ROW_BUCKETS)
        cap = self.max_prefill_rows.get(qp)
        if cap is not None and rb > cap:
            return 1 << 62
        return rb * qp

    def prompt_row_cap(self, chunk_len: int) -> Optional[int]:
        """Row-width cap for the token bucket ``chunk_len`` lands in
        (None = uncapped; 0 = unservable)."""
        return self.max_prefill_rows.get(
            _bucket(chunk_len, self.token_buckets))

    def _kvp_bucket(self, max_pages: int) -> int:
        b = 1
        while b < max_pages:
            b *= 2
        return min(b, max(self.max_kv_pages, 1))

    def set_max_kv_pages(self, n: int) -> None:
        self.max_kv_pages = max(1, n)

    # -- step ----------------------------------------------------------------

    def build_plan(self, tasks: List[TaskState]) -> Dict[str, Any]:
        """Assemble the per-step batch plan (pure host work)."""
        decode_idx = [i for i, t in enumerate(tasks)
                      if len(t.next_tokens) == 1]
        prefill_idx = [i for i, t in enumerate(tasks)
                       if len(t.next_tokens) > 1]

        n_steps = 1
        if (self._multi_step > 1 and not prefill_idx and tasks
                and not any(t.pending_prefill for t in tasks)):
            n_steps = self._multi_step

        bd = _bucket(max(len(decode_idx), 1), self.batch_buckets)
        bp = _bucket(len(prefill_idx), _PREFILL_ROW_BUCKETS)
        qp = (_bucket(max(len(tasks[i].next_tokens)
                          for i in prefill_idx), self.token_buckets)
              if prefill_idx else self.token_buckets[0])
        # page-table width is pinned to the config maximum (the kernels'
        # page walks are data-dependent, so a wider table costs only its
        # bytes)
        kvp = self._kvp_bucket(self.max_kv_pages)

        a = self._plan_arrays(bd, bp, qp, kvp)

        def fill_row(row: int, t: TaskState) -> None:
            pages = t.page_list[:kvp]
            a["page_table"][row, :len(pages)] = pages
            a["context_len"][row] = t.start_pos + len(t.next_tokens)
            if t.slot_index >= 0:
                a["batch_slots"][row] = t.slot_index
            a["temperature"][row] = t.temperature
            # requested k beyond the candidate cap is clamped
            a["top_k"][row] = (min(t.top_k, self.top_k_cap)
                               if self.top_k_cap and t.top_k > 0 else t.top_k)
            a["top_p"][row] = t.top_p
            a["do_sample"][row] = t.do_sample
            a["rep_pen"][row] = t.repetition_penalty
            a["pres_pen"][row] = t.presence_penalty
            a["freq_pen"][row] = t.frequency_penalty

        for row, i in enumerate(decode_idx):
            t = tasks[i]
            a["decode_tokens"][row] = t.next_tokens[0]
            a["decode_pos"][row] = t.start_pos
            fill_row(row, t)
        for prow, i in enumerate(prefill_idx):
            t = tasks[i]
            n = len(t.next_tokens)
            a["prefill_tokens"][prow, :n] = t.next_tokens
            a["prefill_start"][prow] = t.start_pos
            a["prefill_len"][prow] = n
            fill_row(bd + prow, t)

        return {
            "n_steps": n_steps,
            "n_tasks": len(tasks),
            # every row argmaxes (do_sample False covers padding rows):
            # the step skips candidate selection
            "greedy": not a["do_sample"].any(),
            "bd": bd,
            "decode_idx": decode_idx,
            "prefill_idx": prefill_idx,
            "arrays": a,
        }

    def _plan_arrays(self, bd: int, bp: int, qp: int, kvp: int
                     ) -> Dict[str, np.ndarray]:
        """A plan's arrays with every row padding: context 0, page-table
        entries at the trash page, the trash penalty slot, greedy."""
        b = bd + bp
        return {
            "decode_tokens": np.zeros(bd, np.int32),
            "decode_pos": np.zeros(bd, np.int32),
            "prefill_tokens": np.zeros((bp, qp), np.int32),
            "prefill_start": np.zeros(bp, np.int32),
            "prefill_len": np.zeros(bp, np.int32),
            "page_table": np.full((b, kvp), self.spec.trash_page, np.int32),
            "context_len": np.zeros(b, np.int32),
            "batch_slots": np.full(b, self.count_map.shape[0] - 1, np.int32),
            "temperature": np.ones(b, np.float32),
            "top_k": np.ones(b, np.int32),
            "top_p": np.zeros(b, np.float32),
            "do_sample": np.zeros(b, bool),
            "rep_pen": np.ones(b, np.float32),
            "pres_pen": np.zeros(b, np.float32),
            "freq_pen": np.zeros(b, np.float32),
        }

    def _gumbel(self, n_steps: int, b: int, greedy: bool
                ) -> Optional[torch.Tensor]:
        """The dispatch's [N, B, C] sampling noise (None when greedy),
        drawn before the block runs; advances the dispatch counter."""
        seed = self._seed * 1_000_003 + self._step_counter
        self._step_counter += 1
        if greedy:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        v = self.model_cfg.vocab_size
        c = self.top_k_cap if self.top_k_cap and self.top_k_cap < v else v
        return sampling_ops.gumbel_noise((n_steps, b, c), gen, self.device)

    def _run(self, runner: _Runner, packed: torch.Tensor,
             advance: Optional[torch.Tensor],
             prev_tokens: Optional[torch.Tensor],
             gumbel: Optional[torch.Tensor]) -> Dict[str, Any]:
        """Run a block and enqueue, right behind it and before anything
        can replay its graph again, the copies of its results: tokens and
        logprobs into fresh pinned host buffers, the last step's tokens
        into a fresh device tensor (what a device-fed block reads)."""
        toks_dev, lps_dev = runner(packed, advance, prev_tokens, gumbel)
        cuda = self.device.type == "cuda"
        toks = torch.empty(toks_dev.shape, dtype=torch.int32,
                           pin_memory=cuda)
        lps = torch.empty(lps_dev.shape, dtype=torch.float32,
                          pin_memory=cuda)
        toks.copy_(toks_dev, non_blocking=cuda)
        lps.copy_(lps_dev, non_blocking=cuda)
        last = toks_dev[-1].clone()
        self._last_final_tokens = last
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return {"toks": toks, "lps": lps, "event": event, "last_dev": last}

    def dispatch_plan(self, plan: Dict[str, Any], profiler=None
                      ) -> Dict[str, Any]:
        """Enqueue a plan's step or decode block on the device; returns a
        handle for :meth:`fetch_plan_result`.

        With ``plan["feed_device_tokens"]`` the decode tokens are the
        previous dispatch's last sampled tokens on the device (reordered
        by ``plan["feed_perm"]`` when the rows moved): the generator
        dispatches block k+1 before it fetches block k."""
        t0 = time.perf_counter_ns()
        a = plan["arrays"]
        n_steps = plan["n_steps"]
        bd = plan["bd"]
        bp, qp = a["prefill_tokens"].shape
        kvp = a["page_table"].shape[1]
        packed = torch.from_numpy(self._pack_arrays(a))
        cuda = self.device.type == "cuda"
        if cuda:
            packed = packed.pin_memory().to(self.device, non_blocking=True)
        feed = bool(plan.get("feed_device_tokens")
                    and self._last_final_tokens is not None)
        if feed and plan.get("feed_perm") is not None:
            # the previous dispatch's tokens sit at its bucket rows (e.g.
            # prefill rows bd..bd+bp); reorder them to this plan's rows
            perm = torch.from_numpy(np.asarray(plan["feed_perm"], np.int64))
            self._last_final_tokens = self._last_final_tokens.index_select(
                0, perm.to(self.device))
        greedy = plan.get("greedy", False)
        runner = self._get_runner(n_steps, feed, bd, bp, qp, kvp,
                                  greedy=greedy)
        gumbel = self._gumbel(n_steps, bd + bp, greedy)
        self.dispatch_counts["fed" if feed else "plan"] += 1
        t1 = time.perf_counter_ns()

        res = self._run(runner, packed, None,
                        self._last_final_tokens if feed else None, gumbel)
        t2 = time.perf_counter_ns()

        if profiler is not None:
            c = profiler.current
            c.set_input_cost = (t1 - t0) // 1000
            c.model_forward_cost = (t2 - t1) // 1000
        handle = dict(res, n_steps=n_steps, bd=bd, n_tasks=plan["n_tasks"],
                      decode_idx=plan["decode_idx"],
                      prefill_idx=plan["prefill_idx"],
                      # continuation support (dispatch_continuation)
                      packed_dev=packed, advance=0, bp=bp, qp=qp, kvp=kvp,
                      greedy=greedy)
        self._last_handle = handle
        return handle

    @property
    def multi_step_block(self) -> int:
        """Decode-block size (steps per dispatch)."""
        return self._multi_step

    @property
    def last_handle(self) -> Optional[Dict[str, Any]]:
        return self._last_handle

    def continuation_fits(self, handle: Dict[str, Any],
                          tasks: List[TaskState]) -> bool:
        """True when another ``n_steps`` decode block after ``handle``
        still fits the handle's page-table bucket. Prefill-carrying and
        single-step bases can't continue: their packed plan has the wrong
        shape."""
        n = handle["n_steps"]
        if n <= 1 or handle["bp"] != 0:
            return False
        adv = handle["advance"] + n
        max_tok = max(t.start_pos + len(t.next_tokens) + adv + n - 1
                      for t in tasks)
        return -(-max_tok // self.spec.page_size) <= handle["kvp"]

    def dispatch_continuation(self, handle: Optional[Dict[str, Any]] = None,
                              profiler=None) -> Dict[str, Any]:
        """Dispatch the next decode block after ``handle`` with no host
        plan assembly: the device-resident packed plan again, positions
        and context lengths advanced on the device, the base block's last
        sampled tokens fed. ``handle=None`` continues this engine's most
        recent dispatch."""
        if handle is None:
            handle = self._last_handle
        t0 = time.perf_counter_ns()
        n_steps = handle["n_steps"]
        adv = handle["advance"] + n_steps
        runner = self._get_runner(
            n_steps, True, handle["bd"], handle["bp"], handle["qp"],
            handle["kvp"], greedy=handle["greedy"], cont=True)
        advance = torch.full((1,), adv, dtype=torch.int32,
                             device=self.device)
        gumbel = self._gumbel(n_steps, handle["bd"] + handle["bp"],
                              handle["greedy"])
        self.dispatch_counts["continuation"] += 1
        res = self._run(runner, handle["packed_dev"], advance,
                        handle["last_dev"], gumbel)
        t1 = time.perf_counter_ns()
        if profiler is not None:
            profiler.current.model_forward_cost = (t1 - t0) // 1000
        out = dict(handle, advance=adv, **res)
        self._last_handle = out
        return out

    def run_continuation(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dispatch the block after this engine's last dispatch and wait
        for its result (the lockstep-worker entry of the JAX package)."""
        return self.fetch_plan_result(self.dispatch_continuation())

    def fetch_plan_result(self, handle: Dict[str, Any], profiler=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        t2 = time.perf_counter_ns()
        if handle["event"] is not None:
            handle["event"].synchronize()
        tokens = handle["toks"].numpy()        # [N, B_bucket]
        logprobs = handle["lps"].numpy()
        t3 = time.perf_counter_ns()
        if profiler is not None:
            profiler.current.choose_token_cost = (t3 - t2) // 1000

        n_steps = handle["n_steps"]
        bd = handle["bd"]
        # reorder bucket rows back to task order; result [n_steps, tasks]
        out_tokens = np.zeros((n_steps, handle["n_tasks"]), np.int32)
        out_logprobs = np.zeros((n_steps, handle["n_tasks"]), np.float32)
        for row, i in enumerate(handle["decode_idx"]):
            out_tokens[:, i] = tokens[:, row]
            out_logprobs[:, i] = logprobs[:, row]
        for prow, i in enumerate(handle["prefill_idx"]):
            out_tokens[:, i] = tokens[:, bd + prow]
            out_logprobs[:, i] = logprobs[:, bd + prow]
        return out_tokens, out_logprobs

    def clear_penalty_slots(self, slots: Sequence[int]) -> None:
        if self.enable_penalty and len(slots):
            sampling_ops.clear_count_slots(
                self.count_map,
                torch.tensor(list(slots), dtype=torch.int32,
                             device=self.device))

    def heartbeat(self) -> None:
        """Idle keepalive: wait for the device to drain."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- tracing -------------------------------------------------------------

    def start_trace(self, log_dir: str) -> None:
        """Begin a torch.profiler trace (CPU, plus CUDA on the card)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._trace = torch.profiler.profile(activities=acts)
        self._trace_dir = log_dir
        self._trace.start()

    def stop_trace(self) -> None:
        if self._trace is None:
            return
        self._trace.stop()
        os.makedirs(self._trace_dir, exist_ok=True)
        self._trace.export_chrome_trace(
            os.path.join(self._trace_dir, "trace.json"))
        self._trace = None

    # -- memory --------------------------------------------------------------

    def device_memory_stats(self) -> Tuple[int, int]:
        """(total_bytes, free_bytes); zeros on the CPU."""
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            return int(total), int(free)
        return 0, 0


def compute_kv_cache_max_tokens(model_cfg: ModelConfig,
                                resource_cfg: ResourceConfig,
                                free_bytes: int,
                                reserved_bytes: int = 0) -> int:
    """``kv_cache_max_tokens = max_tokens_scale * (free - reserved) /
    block_bytes`` (``resource_manager.cc:329-342``, where nothing is
    reserved); block = K+V across layers at the cache's element size: 1
    byte under int8 KV, plus one bf16 scale per group, as the JAX package
    counts them. ``reserved_bytes``: what the CUDA graphs and their
    warm-up need beside the pool."""
    if resource_cfg.kv_cache_max_tokens:
        return resource_cfg.kv_cache_max_tokens
    int8 = model_cfg.cache_quant_bit == 8
    elem = 1 if int8 else torch.finfo(
        llama.torch_dtype(model_cfg.dtype)).bits // 8
    block = (model_cfg.num_layers * 2 * model_cfg.num_kv_heads
             * model_cfg.head_dim * elem)
    if int8:
        block += (model_cfg.num_layers * 2 * model_cfg.num_kv_heads
                  * model_cfg.head_dim // model_cfg.cache_quant_group * 2)
    if free_bytes <= 0 or block <= 0:
        return 16384  # CPU default
    return int(resource_cfg.max_tokens_scale
               * max(free_bytes - reserved_bytes, 0) / block)
