"""Continuous-batching inference engine on PyTorch.

The counterpart of the JAX package's engine/engine.py for its default
serving path:

- One device state: the paged KV pool shared by `max_slots` concurrent
  requests, per-slot sampler options, per-slot repeat-penalty windows and
  token counts. Prompts pad to the smallest prefill bucket.
- Continuous batching: requests join and leave between decode steps.
- Decode runs in BLOCKS of `decode_block` steps per dispatch, with up to
  `pipeline_depth` blocks in flight ahead of the host: each block's tokens
  are copied to pinned host memory asynchronously and fetched when the
  host needs them, so host bookkeeping overlaps device work. Host-side
  finishing (EOS, stop sequences, num_predict) lags the device by up to
  decode_block × pipeline_depth wasted steps; page-table sentinels drop
  the writes of finished slots and their fetched tokens are discarded.
- Admission never synchronizes: the prefill samples the first token on
  the device; the host first sees it in row 0 of the next block it
  fetches, matched by a per-slot dispatch-generation tag.
- `EngineConfig`'s serving knobs (prefix cache, speculation, draft model,
  attention mode, int8 pool) left None read their GRIDLLM_* names at
  construction with the JAX package's defaults, so one fleet environment
  sets torch and JAX engines alike (`EngineConfig.resolved`).
- Prompts longer than `prefill_chunk`, and prompts whose prefix is in the
  prefix cache, prefill in page-aligned chunks. With ragged attention on
  (the default) each chunk is a `mixed_step`: ONE ragged attention launch
  per layer together with one decode token for every running slot. With
  it off (`EngineConfig.ragged_attention=False`, the counterpart of the
  JAX package's GRIDLLM_RAGGED_ATTN=0) each chunk is a `prefill_chunk`
  through the per-phase dispatchers, and decode and verify use them too.
- Speculative decoding (on by default, K = 4, as the JAX package resolves
  it): each step drafts up to K tokens per slot from its own history
  (n-gram prompt lookup, ops/spec.py), verifies all of them in ONE batched
  forward (`verify_step`), keeps the longest accepted prefix plus one
  corrected token (`spec_accept`) and rolls the lengths back past the
  rejected rows. Greedy streams are token-identical to spec-off. A verify
  step is fetched at once: the next step's drafts depend on its tokens, so
  there is no block pipeline to hide the fetch behind.
- Draft-model tree speculation (`EngineConfig.draft_model`, the JAX
  package's GRIDLLM_SPEC_DRAFT_MODEL): a small same-vocabulary model
  drafts, in one batch over all slots, a static token tree per slot (a
  depth-K greedy chain plus `spec_tree_width - 1` first-level siblings);
  one tree-masked verify forward (`verify_step` with the topology) feeds
  `spec_accept_tree`, and `commit_tree_path` compacts the accepted path's
  K/V rows before the lengths roll forward. An unknown or incompatible
  draft model logs a warning and leaves n-gram drafting in place, as in
  the JAX package.
- An int8 KV pool (`EngineConfig.kv_int8`, the JAX package's
  GRIDLLM_KV_INT8; off by default as there): int8 values plus one float32
  scale per (layer, page, row), about half the bytes of a bf16 pool. Writes
  quantize each row; decode, verify and mixed steps read the pool through
  the ragged kernel's int8 leg.

- KV movement (the JAX engine's export/import and host tier):
  `export_prefix_pages` gathers the cached full-page prefix of a prompt to
  host arrays for the migration wire (transfer/wire.py),
  `import_prefix_pages` installs migrated pages into the pool and the
  prefix cache, an `export_only` request (a disaggregated prefill) finishes
  at its first token with its prompt's pages cached, and with
  `kv_host_bytes` > 0 pages evicted from the prefix cache spill to a host
  tier (ops/kvtier.py) and page back in on a prefix match;
  `park_to_host` moves a suspended request's pages there.

- Embeddings (`embed`): texts grouped by prefill bucket and by batch
  bucket (1, 4, 16, 32; at most `embed_batch` rows), one cache-free
  `hidden_states` forward per batch with a valid length per row, pooled
  and L2-normalized (`bert_embed.pool`: the config's `pooling`, mean for
  every decoder family). A bert_embed model makes an `embedding_only`
  engine: no pool, sampler, runner or drafter, and generation is refused.
  On an engine whose runner is live each batch runs on the runner thread
  between two of its steps, so it never interleaves with a step's
  launches and never starts or stops inside a profiler capture.
- Images (the llava family): each request's base64 images are decoded and
  preprocessed on the host at admission (engine/images.py), on the runner
  thread as in the JAX engine (the PNG decode and resize are numpy steps
  driven by Python loops: threads beside the runner would contend with it
  for the interpreter lock, PERF.md); each image
  placeholder expands to `num_patches` image tokens, the tower and
  projector encode the images once (`encode_images`) and the prefill —
  bucket, chunk or mixed step — takes the spliced embeddings in place of
  the token lookup (`splice_embeds`, each chunk with the image tokens
  before it as its offset). Image requests never match or register in the
  prefix cache and never resume: token ids do not address pixels.

- Tensor parallelism (`EngineConfig.mesh`, a tp-only MeshConfig; every
  family but mixtral, which waits for ep, ROADMAP A 9): the engine runs on
  one rank of an initialized torch.distributed group
  (parallel/distributed.py), its model holds the rank's weight slices and
  its pool the rank's kv heads (`pool_kv_heads`), and the collectives join
  the ranks inside every model call. Int8 weights, both attention modes,
  images, embeddings, the prefix cache and draft-model trees run under a
  mesh; the int8 KV pool, the host KV tier and KV transfer are off
  (logged), as in the JAX engine. The group's ranks must issue the same
  model calls in the same order: the liaison's engine records each
  device-dispatching action through `plan_sink` (admit, block, verify,
  verify_tree, deact, embed, reset: plain host data) and a follower's
  engine replays them with `apply_plan_op`. The liaison's allocator alone
  decides prefix hits and evictions: an admit record carries the slot's
  page row and its `cached` length, and a follower never looks up or
  evicts. The draft model of a tree runs whole (unmeshed) on rank 0, the
  liaison, alone: its drafts reach the followers only in the verify_tree
  records (the JAX engine shards the draft over the target's mesh; it
  too has no record for the draft pass), so a group with a draft model
  runs through plan replay. Records go out BEFORE their
  dispatch, unlike the JAX engine's: a torch collective blocks the host
  until every rank has reached it, so the liaison would wait in its first
  all-reduce for a follower still waiting for the record. `dispatch_lock`
  makes (record, dispatch) atomic, so record order is dispatch order
  across threads (an embed batch run on the calling thread) and, shared
  across a worker's engines, across models. Followers never read results
  back, but they sample: the logits are gathered on every rank and the
  sampler's threefry stream is the same everywhere, so their device state
  evolves as the liaison's. With a `plan_sink` the host KV tier neither
  spills nor restores, and KV export and import are off.

- Profiling a serving engine (the JAX engine's `jax.profiler` capture):
  `profile()` is a torch.profiler capture that starts and stops on the
  engine's runner thread while every runner thread of the process waits
  between two steps (`_ProfileGate`); runners refuse to serve under a
  capture that no engine's `profile()` started (see `profile`).

Unlike the JAX engine, whose device state is immutable, the state tensors
here are updated in place; every block's token output is a fresh tensor
copied out before the next block runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator

import numpy as np
import torch

from gridllm_torch import faults
from gridllm_torch.engine.images import preprocess_images
from gridllm_torch.engine.loader import load_checkpoint, model_class, weight_snapshot_tier
from gridllm_torch.engine.tokenizer import DetokState, Tokenizer, get_tokenizer
from gridllm_torch.models.configs import config_from_hf_dir, get_config
from gridllm_torch.obs import SIZE_BUCKETS, default_registry
from gridllm_torch.obs.perf import DEVICE_STEP_SECONDS, DISPATCH_SECONDS, HOST_SCHED_SECONDS
from gridllm_torch.ops.kvcache import (
    PagedKVCache,
    PageAllocator,
    QuantPages,
    commit_tree_path,
    rollback_to_length,
)
from gridllm_torch.ops.kvtier import (
    HostKVTier,
    dequantize_page,
    quantize_rows_np,
    set_tier_gauges,
)
from gridllm_torch.ops.sampling import (
    SamplingParams,
    sample_tokens,
    spec_accept,
    spec_accept_tree,
    window_push,
    window_set_slot,
)
from gridllm_torch.ops.spec import (
    DraftModelDrafter,
    make_drafter,
    tree_ancestor_mask,
    tree_depths,
    tree_topology,
)
from gridllm_torch.parallel.mesh import build_mesh
from gridllm_torch.parallel.sharding import pool_kv_heads
from gridllm_torch.utils.config import env_bool, env_int, env_str

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Engine-plane instruments, the JAX engine's series (names, help, labels
# and buckets) on the process-global registry (the worker's /metrics).
# Updated from the driving thread only, once per step at most.
_OBS = default_registry()
_TOKENS_TOTAL = _OBS.counter(
    "gridllm_engine_tokens_total",
    "Tokens processed, by model and kind (prefill = prompt tokens "
    "dispatched, decode = tokens sampled and ingested).",
    ("model", "kind"),
)
_STEP_DURATION = _OBS.histogram(
    "gridllm_engine_step_duration_seconds",
    "Per-decode-step wall time (fused-block fetch time divided by the "
    "block's step count), by model.",
    ("model",),
)
_BATCH_OCCUPANCY = _OBS.histogram(
    "gridllm_engine_batch_occupancy",
    "Active slots at each decode-block dispatch, by model.",
    ("model",), buckets=SIZE_BUCKETS,
)
_KV_PAGES_USED = _OBS.gauge(
    "gridllm_engine_kv_pages_used", "KV page-pool pages in use, by model.",
    ("model",),
)
_KV_PAGES_FREE = _OBS.gauge(
    "gridllm_engine_kv_pages_free", "KV page-pool pages free, by model.",
    ("model",),
)
_KV_PAGES_CACHED = _OBS.gauge(
    "gridllm_engine_kv_pages_cached",
    "KV page-pool pages parked in the prefix-cache reuse LRU (refcount 0, "
    "evictable), by model.",
    ("model",),
)
_PREFIX_HIT_RATE = _OBS.gauge(
    "gridllm_prefix_cache_hit_rate",
    "Cumulative prompt-page prefix-cache hit rate (hits / (hits+misses)), "
    "by model.",
    ("model",),
)
# cold-start cost by how the weights arrived: "snapshot" (host-RAM weight
# tier hit), "checkpoint" (safetensors read), "init" (random init)
_MODEL_LOAD_SECONDS = _OBS.histogram(
    "gridllm_model_load_seconds",
    "Engine weight-load wall time at (re)construction, by model and "
    "weight source (snapshot = host-RAM tier hit, checkpoint = disk "
    "safetensors, init = fresh init).",
    ("model", "source"),
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
)
# speculative decoding: proposed = drafts sent to a verify step, accepted =
# drafts the model agreed with, rejected = the rest; by drafter kind
# ("ngram" or "model")
_SPEC_PROPOSED = _OBS.counter(
    "gridllm_spec_proposed_tokens_total",
    "Draft tokens proposed to speculative verify steps, by model and "
    "drafter kind.",
    ("model", "drafter"),
)
_SPEC_ACCEPTED = _OBS.counter(
    "gridllm_spec_accepted_tokens_total",
    "Draft tokens accepted by speculative verify steps, by model and "
    "drafter kind.",
    ("model", "drafter"),
)
_SPEC_REJECTED = _OBS.counter(
    "gridllm_spec_rejected_tokens_total",
    "Draft tokens rejected (or discarded past the first miss) by "
    "speculative verify steps, by model and drafter kind.",
    ("model", "drafter"),
)
_SPEC_ACCEPT_RATE = _OBS.histogram(
    "gridllm_spec_acceptance_rate",
    "Per-verify-step draft acceptance rate (accepted/proposed, over steps "
    "with at least one proposed draft), by model and drafter kind.",
    ("model", "drafter"), buckets=(0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
)
# the families whose torch model can draft (each has verify and decode
# steps: every family the port serves)
_DRAFT_FAMILIES = ("llama", "qwen2", "qwen3", "gemma2")

_FOREIGN_CAPTURE = (
    "InferenceEngine: a torch.profiler capture that InferenceEngine.profile() "
    "did not start is active; the runner thread does not serve under it (CUPTI "
    "can crash when a capture starts or stops while another thread launches "
    "kernels): capture through InferenceEngine.profile()")


class _ProfileGate:
    """Process-wide gate between the engines' runner threads and
    InferenceEngine.profile(). A runner holds it shared for each of its
    steps; a capture's start or stop holds it alone (the thread that does it
    may be inside its own step), so no runner of the process launches
    kernels while CUPTI turns tracing on or off. `owner` is the engine whose
    profile() capture is active (one at a time: torch runs one profiler)."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._stepping: set[int] = set()   # runner threads inside a step
        self._switching = False
        self.owner: InferenceEngine | None = None
        self.claim = threading.Lock()      # held from a capture's start to its stop

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        me = threading.get_ident()
        with self._cv:
            self._cv.wait_for(lambda: not self._switching)
            self._stepping.add(me)
        try:
            yield
        finally:
            with self._cv:
                self._stepping.discard(me)
                self._cv.notify_all()

    @contextlib.contextmanager
    def switch(self, deadline: float | None = None) -> Iterator[None]:
        """Hold every runner between its steps; past `deadline` (a
        time.monotonic() instant; None waits for ever) raise TimeoutError
        instead, the runners released."""
        me = threading.get_ident()

        def left():
            return None if deadline is None else max(0.0, deadline - time.monotonic())

        with self._cv:
            if not self._cv.wait_for(lambda: not self._switching, left()):
                raise TimeoutError("InferenceEngine.profile(): another capture kept the gate")
            self._switching = True
            if not self._cv.wait_for(lambda: self._stepping <= {me}, left()):
                self._switching = False
                self._cv.notify_all()
                raise TimeoutError("InferenceEngine.profile(): a runner stayed inside its step")
        try:
            yield
        finally:
            with self._cv:
                self._switching = False
                self._cv.notify_all()


_GATE = _ProfileGate()

@dataclasses.dataclass
class EngineConfig:
    model: str
    # an HF-layout safetensors directory; None = random weights (seed 0)
    checkpoint_path: str | None = None
    tokenizer: str | None = None         # None/"byte" → ByteTokenizer
    dtype: str = "bfloat16"
    # "int8": per-out-channel weight-only quantization of the matmul
    # leaves (ops/quant.py); the draft model stays unquantized
    quantize: str | None = None
    max_slots: int = 8
    page_size: int = 64
    num_pages: int = 1024
    max_pages_per_slot: int = 128
    prefill_buckets: tuple[int, ...] = (64, 256, 1024, 4096)
    # a parallel.mesh.MeshConfig: tensor parallelism over the initialized
    # torch.distributed group this process is a rank of (tp only)
    mesh: Any = None
    max_queue: int = 512
    seed: int | None = None              # engine-level seed for unseeded requests
    embed_batch: int = 32                # most texts per embedding forward
    # prompts longer than this prefill in chunks against the cached prefix;
    # rounded down to a multiple of page_size (page-aligned chunk starts)
    prefill_chunk: int = 1024
    decode_block: int = 8                # decode steps per runner dispatch
    pipeline_depth: int = 2              # blocks in flight ahead of the host
    admit_per_block: int = 2             # admissions per block while busy
    repeat_window: int = 256             # width of the repeat-penalty window
    # The knobs below default to None: the engine reads each from its
    # GRIDLLM_* name at construction (`resolved`), as the JAX engine does,
    # and an explicit value wins.
    # prefix cache: completed requests park their full KV pages in a
    # content-addressed reuse LRU; prefix_cache_pages bounds it (-1 = whole
    # pool, 0 = off). GRIDLLM_PREFIX_CACHE, GRIDLLM_PREFIX_CACHE_PAGES.
    prefix_cache: bool | None = None
    prefix_cache_pages: int | None = None
    # speculative decoding (n-gram drafting + batched verify): spec_k is
    # the drafted tokens verified per step (a [S, K+1] verify block).
    # GRIDLLM_SPEC_DECODE, GRIDLLM_SPEC_K.
    spec_decode: bool | None = None
    spec_k: int | None = None
    # draft-model tree speculation: the draft model's config name ("" =
    # n-gram drafting), the first-level fan-out of its token tree (1 = a
    # pure chain), the tokens per catch-up chunk of its ingest and its
    # weights ("" = random). GRIDLLM_SPEC_DRAFT_MODEL,
    # GRIDLLM_SPEC_TREE_WIDTH, GRIDLLM_SPEC_DRAFT_INGEST,
    # GRIDLLM_SPEC_DRAFT_CHECKPOINT.
    draft_model: str | None = None
    spec_tree_width: int | None = None
    draft_ingest: int | None = None
    draft_checkpoint: str | None = None
    # attention mode: the unified ragged kernel (True) or the per-phase
    # dispatchers paged_decode / prefix_chunk (False). GRIDLLM_RAGGED_ATTN.
    ragged_attention: bool | None = None
    # host KV tier: its capacity in bytes (prefix-cache pages evicted from
    # the device pool spill there and page back in on a prefix match; 0 =
    # off; None = GRIDLLM_KV_HOST_BYTES) and whether an fp page is int8-
    # quantized on spill (one scale per layer and page; False spills raw
    # bytes, so tier-on streams equal tier-off; None = GRIDLLM_KV_SPILL_INT8)
    kv_host_bytes: int | None = None
    kv_spill_int8: bool | None = None
    # resident int8 KV pool (values + per-row float32 scales).
    # GRIDLLM_KV_INT8.
    kv_int8: bool | None = None

    def resolved(self) -> EngineConfig:
        """This config with each knob left None read from the environment
        (the JAX engine's `_resolve_*` reads, with the same defaults)."""
        def pick(value, read):
            return read() if value is None else value

        return dataclasses.replace(
            self,
            prefix_cache=bool(pick(self.prefix_cache, lambda: env_bool("GRIDLLM_PREFIX_CACHE"))),
            prefix_cache_pages=int(pick(self.prefix_cache_pages,
                                        lambda: env_int("GRIDLLM_PREFIX_CACHE_PAGES"))),
            spec_decode=bool(pick(self.spec_decode, lambda: env_bool("GRIDLLM_SPEC_DECODE"))),
            spec_k=int(pick(self.spec_k, lambda: env_int("GRIDLLM_SPEC_K"))),
            draft_model=(pick(self.draft_model, lambda: env_str("GRIDLLM_SPEC_DRAFT_MODEL"))
                         or "").strip() or None,
            spec_tree_width=int(pick(self.spec_tree_width,
                                     lambda: env_int("GRIDLLM_SPEC_TREE_WIDTH"))),
            draft_ingest=int(pick(self.draft_ingest,
                                  lambda: env_int("GRIDLLM_SPEC_DRAFT_INGEST"))),
            draft_checkpoint=(pick(self.draft_checkpoint,
                                   lambda: env_str("GRIDLLM_SPEC_DRAFT_CHECKPOINT"))
                              or "").strip() or None,
            ragged_attention=bool(pick(self.ragged_attention,
                                       lambda: env_bool("GRIDLLM_RAGGED_ATTN"))),
            kv_int8=bool(pick(self.kv_int8, lambda: env_bool("GRIDLLM_KV_INT8"))),
        )

    def check_ported(self) -> None:
        """Raise for a setting whose feature this package does not have."""
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype {self.dtype!r} (have {sorted(_DTYPES)})")
        if self.quantize and self.quantize != "int8":
            raise ValueError(f"unknown quantize mode: {self.quantize!r}")


@dataclasses.dataclass
class GenerationRequest:
    id: str
    prompt: str | None = None
    prompt_ids: list[int] | None = None  # pre-tokenized (Ollama `context` path)
    options: dict[str, Any] = dataclasses.field(default_factory=dict)
    raw: bool = False                    # skip BOS when prompt_ids is None
    # base64 images (vision models): one placeholder per image in the
    # prompt, or none (the images then go first, after BOS)
    images: list[str] | None = None
    # disaggregated prefill: finish at the FIRST host-visible token with
    # done_reason "export"; the prompt's KV pages land in the prefix cache
    # (the normal finish path) ready for export_prefix_pages, and no text is
    # detokenized or streamed
    export_only: bool = False
    # decode resume: token ids a previous attempt already generated. They
    # join the prompt for prefill and allocation but seed the slot's
    # generated state (detokenizer, stops, num_predict, eval_count), and the
    # sampler's (seed, step) chain restarts at step = len(resume_ids), so a
    # greedy or seeded stream continues as the undisturbed run would
    resume_ids: list[int] | None = None
    # chars of the resumed text already delivered: emission restarts past them
    resume_sent: int = 0
    # write the (generated ids, text) resume watermark every N surviving
    # tokens (0 = never)
    snapshot_every: int = 0
    # called from the engine loop: (text_delta, done, result|None)
    on_chunk: Callable[[str, bool, "GenerationResult | None"], None] | None = None


@dataclasses.dataclass
class GenerationResult:
    id: str
    text: str = ""
    token_ids: list[int] = dataclasses.field(default_factory=list)
    context: list[int] = dataclasses.field(default_factory=list)
    done_reason: str = "stop"
    prompt_eval_count: int = 0
    cached_tokens: int = 0               # prompt tokens served from the prefix cache
    prompt_eval_duration_ns: int = 0     # admission → first host-visible token
    eval_count: int = 0
    eval_duration_ns: int = 0
    load_duration_ns: int = 0
    total_duration_ns: int = 0
    retryable: bool = True
    error: str = ""
    # speculative decoding: drafts proposed to and accepted by this
    # request's verify steps (both 0 with speculation off)
    spec_proposed: int = 0
    spec_accepted: int = 0
    # usage attribution: this request's share of the decode steps' device
    # seconds, and KV page occupancy (pages held x resident wall seconds)
    decode_device_s: float = 0.0
    kv_page_s: float = 0.0


class _Slot:
    __slots__ = (
        "req", "ids", "prompt_len", "generated", "detok", "text", "emitted_len",
        "num_predict", "stop_seqs", "eos_ids", "capacity", "joined_gen",
        "cached_tokens", "t_start", "t_prefill_ns", "t_first_decode",
        "t_last_ingest", "spec_proposed", "spec_accepted", "snapshot",
        "t_admit_wall", "pages_held", "device_s", "export_only",
    )

    def __init__(self, req: GenerationRequest, ids: list[int], capacity: int,
                 num_predict: int, stop_seqs: list[str], eos_ids: frozenset[int]):
        self.req = req
        self.ids = ids                   # prompt ids (grows with generation)
        self.prompt_len = len(ids)
        self.generated: list[int] = []
        self.detok = DetokState()
        self.text = ""
        self.emitted_len = 0             # chars of `text` already sent out
        self.num_predict = num_predict
        self.stop_seqs = stop_seqs
        self.eos_ids = eos_ids
        self.capacity = capacity         # max total tokens this slot may hold
        self.cached_tokens = 0
        # dispatch generation of the FIRST block that will see this slot:
        # its row 0 carries the prefill-sampled token; older blocks predate
        # the slot and are skipped for it
        self.joined_gen = 0
        self.t_start = time.perf_counter_ns()
        self.t_prefill_ns = 0
        self.t_first_decode = 0
        self.t_last_ingest = 0.0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # last consistent (generated ids, text) pair: the resume watermark.
        # Written only by the engine thread, as one tuple per surviving
        # token at the request's cadence, so a reader on another thread
        # always sees a matched pair
        self.snapshot: tuple[list[int], str] | None = None
        self.t_admit_wall = time.time()
        self.pages_held = 0              # KV pages allocated to this slot
        self.device_s = 0.0              # accumulated decode device-second share
        self.export_only = req.export_only  # disaggregated prefill: stop at token 1

    def holdback(self) -> int:
        """Chars at the tail of `text` that could still become a stop
        sequence — not emitted yet."""
        hold = 0
        for seq in self.stop_seqs:
            for k in range(min(len(seq), len(self.text)), 0, -1):
                if self.text.endswith(seq[:k]):
                    hold = max(hold, k)
                    break
        return hold


class InferenceEngine:
    """Synchronous core driven by step() (tests, sync callers), or the
    runner thread started by start() (serving)."""

    def __init__(self, config: EngineConfig, device: str | torch.device = "cuda",
                 params: dict[str, Any] | None = None,
                 draft_params: dict[str, Any] | None = None):
        """`device`: "cuda" (the default) or "cpu". The weights come, in
        order, from `params` (a JAX-layout pytree of numpy arrays), a
        snapshot of the same checkpoint identity in the host weight tier
        (`snapshot_key`), `config.checkpoint_path`, or random init (seed
        0); `load_source` says which of the last three. `draft_params` is
        the draft model's pytree (else `config.draft_checkpoint`, else
        random weights drawn as the target's are, so a draft model named
        like the target gets the target's random weights). An unregistered
        `config.model` with a checkpoint_path reads its config.json. With
        GRIDLLM_PREWARM_COMPILES=1 the engine serves one greedy token
        before it returns (`prewarm`)."""
        config.check_ported()
        config = config.resolved()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InferenceEngine: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.config = config
        try:
            self.cfg = get_config(config.model)
        except KeyError:
            if not config.checkpoint_path:
                raise
            # an unregistered name with a checkpoint: its HF config.json
            self.cfg = config_from_hf_dir(config.model, config.checkpoint_path)
        self.dtype = _DTYPES[config.dtype]
        self._rng = random.Random(config.seed)
        # an encoder family: embeddings only, no generation state
        self.embedding_only = self.cfg.family == "bert_embed"
        self.mesh = build_mesh(config.mesh) if config.mesh is not None else None
        if self.mesh is not None:
            config = self._check_mesh(config)
            self.config = config
        self._prefix_cache_cap = (
            max(config.prefix_cache_pages, -1)
            if config.prefix_cache and not self.embedding_only else 0)
        # resolved once: the host tier outlives device-state resets (its
        # content-addressed pages stay valid)
        self.host_tier = None if self.embedding_only else self._build_host_tier()
        self._lock = threading.Lock()
        self._alloc_lock = threading.RLock()
        # serializes embed batches run on the calling thread (no live runner)
        self._embed_lock = threading.Lock()
        self._pending: deque[GenerationRequest] = deque()
        self._slots: dict[int, _Slot] = {}
        # host copy of each live or admitting slot's temperature
        self._temps: dict[int, float] = {}
        self._free_slots = list(range(config.max_slots - 1, -1, -1))
        self._gen = 0   # generation counter of dispatched blocks
        # (gen, host tokens [k+1, S], copy-done event or None, k)
        self._inflight: deque[tuple[int, torch.Tensor, Any, int]] = deque()
        # ("cancel", req_id), or ("call", (fn, done, errors)): a call made
        # between two steps (profile()'s start and stop)
        self._ctl: deque[tuple[str, Any]] = deque()
        self._work = threading.Condition()
        self._runner: threading.Thread | None = None
        self._runner_stop = threading.Event()
        # speculation depth K (0 = off) and cumulative verify-step totals
        self._spec_k = (max(int(config.spec_k), 0)
                        if config.spec_decode and not self.embedding_only else 0)
        self._drafter = None
        self._tree_width = max(int(config.spec_tree_width), 1)
        self.spec_stats = {"steps": 0, "proposed": 0, "accepted": 0, "emitted": 0,
                           "draft_ns": 0}
        # worker-group lockstep (see the module docstring): the liaison's
        # record sink, and the lock that keeps record and dispatch together
        self.plan_sink: Callable[[dict[str, Any]], None] | None = None
        self.dispatch_lock: threading.RLock = threading.RLock()
        # step-time decomposition state (driving thread only)
        self._t_prev_fetch: float | None = None
        self._t_ingest_done: float | None = None

        self.prewarm_duration_ns = 0
        t0 = time.perf_counter_ns()
        self._load_weights(params)
        # after the weights: a checkpoint directory without them fails on
        # its safetensors, not on its tokenizer
        self.tokenizer: Tokenizer = get_tokenizer(config.tokenizer, self.cfg.vocab_size)
        if self.embedding_only:
            # no KV pool: a text's length is bounded by the model alone
            self.max_context = self.cfg.max_seq_len
        else:
            self._init_device_state()
            self.max_context = min(self.cfg.max_seq_len,
                                   config.max_pages_per_slot * config.page_size)
        # a group's follower replays the liaison's verify_tree records and
        # never drafts (the draft model lives on the liaison only)
        self._replays_drafts = bool(
            self._spec_k and config.draft_model and self.mesh is not None
            and self.mesh.rank != 0)
        if self._spec_k:
            self._drafter = (None if self._replays_drafts
                             else self._build_model_drafter(draft_params)) or make_drafter()
        # the draft tree's static topology, its node depths and ancestor mask
        parents = tree_topology(self._spec_k, self._tree_width)
        self._tree = (parents, tree_depths(parents), tree_ancestor_mask(parents))
        self.load_duration_ns = time.perf_counter_ns() - t0
        _MODEL_LOAD_SECONDS.observe(self.load_duration_ns / 1e9, model=self.cfg.name,
                                    source=self.load_source)
        # every admissible length maps to a fixed padded shape
        self._buckets = sorted(
            {min(b, self.max_context) for b in config.prefill_buckets}
            | {self.max_context})
        ps = config.page_size
        self._chunk_len = max(ps, (min(config.prefill_chunk, self.max_context) // ps) * ps)
        if env_bool("GRIDLLM_PREWARM_COMPILES") and not self.embedding_only:
            self.prewarm()

    def _check_mesh(self, config: EngineConfig) -> EngineConfig:
        """The refusals (a family that does not run under a mesh: ROADMAP A
        9) and the settings switched off under a mesh, as in the JAX
        engine: the int8 KV pool (the host tier and KV transfer are off in
        `_build_host_tier` and `kv_transfer_supported`)."""
        from gridllm_torch.models.llama import validate_mesh

        validate_mesh(self.cfg, self.mesh)
        if config.kv_int8:
            log.info("int8 KV pool disabled: meshed pools keep the fp layout")
        return dataclasses.replace(config, kv_int8=False)

    # ---------------------------------------------------------- weights

    def _load_weights(self, params: dict[str, Any] | None) -> None:
        """Build the model and fill its weights (see __init__): a restore
        from the snapshot tier runs under the fault site
        swap.snapshot_restore, and an injected fault falls through to the
        checkpoint or init, never a failed load."""
        c = self.config
        # int8 leaves are allocated as int8 + scales and filled a layer
        # slice at a time on every path; a snapshot was parked quantized
        # and is restored as it is, with no re-quantization
        meshed = {"mesh": self.mesh} if self.mesh is not None else {}
        self.model = model_class(self.cfg)(self.cfg, dtype=self.dtype, device=self.device,
                                           ragged_attention=c.ragged_attention,
                                           quantize=c.quantize or None, **meshed)
        if params is not None:
            self.model.params_from_jax(params)
            self.load_source = "init"
            return
        snap = None
        tier = weight_snapshot_tier()
        if tier.enabled:
            try:
                faults.inject("swap.snapshot_restore")
                snap = tier.restore(self.snapshot_key())
            except faults.InjectedFault:
                log.warning("weight snapshot restore fault; loading %s instead",
                            c.checkpoint_path or "random weights")
                snap = None
        if snap is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    p.copy_(snap[name], non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.load_source = "snapshot"
        elif c.checkpoint_path:
            load_checkpoint(self.cfg, c.checkpoint_path, model=self.model,
                            quantize=c.quantize or None)
            self.load_source = "checkpoint"
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            self.model.init_params(gen)
            self.load_source = "init"

    def snapshot_key(self) -> str:
        """Checkpoint identity in the weight snapshot tier: everything that
        changes the weights (the JAX engine's key, string for string), and
        under a mesh the rank whose slices they are."""
        c = self.config
        key = "|".join((self.cfg.name, c.checkpoint_path or "init", str(c.dtype),
                        c.quantize or "none", str(c.mesh or "")))
        if c.mesh is None:
            return key
        import torch.distributed as dist

        return f"{key}|rank {dist.get_rank() if dist.is_initialized() else 0}"

    def park_weights(self) -> bool:
        """Park the weights in the host snapshot tier (call after stop(), on
        the unload path), then free them on the device: every parameter's
        storage is dropped and the caching allocator's blocks returned, so
        the device's used memory falls by the weights' bytes. False (and
        nothing freed) when the tier is off or the weights exceed it."""
        model = self.model
        if model is None or not weight_snapshot_tier().enabled:
            return False
        ok = weight_snapshot_tier().park(self.snapshot_key(), dict(model.named_parameters()))
        if ok:
            model.free_params()
            self.model = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return ok

    def prewarm(self) -> None:
        """Serve one greedy token through the smallest prefill bucket and a
        decode (or verify) step before the first real request, so the first
        request does not pay the process's first launches (the CUDA
        context's lazy module loads, the allocator's first blocks, cuBLAS
        handles). Fills `prewarm_duration_ns`."""
        if self.embedding_only or self.running:
            return
        t0 = time.perf_counter_ns()
        self.generate(GenerationRequest(
            id="prewarm", prompt_ids=[1], raw=True,
            options={"temperature": 0, "seed": 0, "num_predict": 1}))
        self.prewarm_duration_ns = time.perf_counter_ns() - t0
        log.info("engine prewarmed: %s in %d ms", self.cfg.name,
                 self.prewarm_duration_ns // 1_000_000)

    # ---------------------------------------------------------- state setup

    def _init_device_state(self) -> None:
        c, mc, dev = self.config, self.cfg, self.device
        self.cache = PagedKVCache.create(
            mc.num_layers, c.num_pages, c.page_size, pool_kv_heads(mc, self.mesh), mc.head_dim_,
            c.max_slots, c.max_pages_per_slot, dtype=self.dtype, device=dev,
            kv_int8=bool(c.kv_int8))
        self.alloc = PageAllocator(c.num_pages, c.page_size, c.max_pages_per_slot,
                                   cache_pages=self._prefix_cache_cap, model=mc.name)
        if self.host_tier is not None:
            # eviction spills to host memory, a match_prefix miss consults
            # it: both fire under _alloc_lock from inside the allocator
            self.alloc.spill_sink = self._spill_page_to_host
            self.alloc.restore_source = self._restore_page_from_host
        self.sampling = SamplingParams.defaults(c.max_slots, dev)
        self.counts = torch.zeros((c.max_slots, mc.vocab_size), dtype=torch.int32, device=dev)
        self.window = torch.zeros((c.max_slots, c.repeat_window), dtype=torch.int32, device=dev)
        self.wlen = torch.zeros((c.max_slots,), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((c.max_slots,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((c.max_slots,), dtype=torch.bool, device=dev)

    def reset_device_state(self) -> None:
        """Rebuild the device state after a failed step (slot state is
        discarded; call abort_all() first). Weights survive."""
        if self.embedding_only:
            return
        with self._alloc_lock, self.dispatch_lock:
            self._record({"op": "reset"})
            self._slots.clear()
            self._temps.clear()
            self._inflight.clear()
            self._t_prev_fetch = None   # recovery wall must not read as
            self._t_ingest_done = None  # device or host pace
            self._free_slots = list(range(self.config.max_slots - 1, -1, -1))
            self._init_device_state()
            if isinstance(self._drafter, DraftModelDrafter):
                self._drafter.reset()
            self._update_kv_gauges()

    def _build_model_drafter(self, draft_params) -> DraftModelDrafter | None:
        """The draft-model tree drafter, or None when no draft model is
        configured or the configured one cannot draft for the target (the
        caller then keeps n-gram drafting, with a warning, as the JAX
        package does). The draft model runs in the engine's dtype and
        attention mode with its own fixed-stripe pool: per slot, pages for
        the engine's max_context plus the draft chain."""
        name = (self.config.draft_model or "").strip()
        if not name:
            return None
        try:
            dcfg = get_config(name)
        except KeyError:
            log.warning("draft model %r unknown; drafting with n-grams", name)
            return None
        if dcfg.vocab_size != self.cfg.vocab_size:
            log.warning("draft model %r has vocabulary %d, the target %d; drafting with "
                        "n-grams", name, dcfg.vocab_size, self.cfg.vocab_size)
            return None
        if dcfg.family not in _DRAFT_FAMILIES:
            log.warning("draft model %r: no verify/decode steps for its family %r; "
                        "drafting with n-grams", name, dcfg.family)
            return None
        c = self.config
        model = model_class(dcfg)(dcfg, dtype=self.dtype, device=self.device,
                                  ragged_attention=c.ragged_attention)
        if draft_params is not None:
            model.params_from_jax(draft_params)
        elif c.draft_checkpoint:
            load_checkpoint(dcfg, c.draft_checkpoint, model=model)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            model.init_params(gen)
        pages = -(-(self.max_context + self._spec_k + 1) // c.page_size)
        return DraftModelDrafter(model, max_slots=c.max_slots, page_size=c.page_size,
                                 max_pages_per_slot=pages, ingest_width=c.draft_ingest)

    # ---------------------------------------------------------- device steps

    def _noise(self) -> bool:
        """Whether a live or admitting slot samples (temperature > 0): with
        none, the sampler draws no noise (the greedy result is the same)."""
        return any(t > 0 for t in self._temps.values())

    def _ids_tensor(self, ids: list[int], width: int) -> torch.Tensor:
        return torch.tensor(ids + [0] * (width - len(ids)), dtype=torch.int32,
                            device=self.device)

    def _activate(self, slot: int, logits: torch.Tensor) -> None:
        """Sample a fresh slot's first token from its prompt's last logits
        and fold it into the device state: tokens[slot], the penalty window,
        active, and the noise counter (the draw consumed step 0)."""
        sp, vocab = self.sampling, self.cfg.vocab_size
        tok = sample_tokens(logits[None], sp.gather(slot), self.counts[slot][None],
                            noise=self._temps.get(slot, 0.0) > 0)[0]
        self.tokens[slot] = tok
        one = torch.zeros_like(self.active)
        one[slot] = True
        window_push(self.window, self.wlen, self.counts, self.tokens, one,
                    sp.repeat_last_n, vocab)
        self.active[slot] = True
        sp.step[slot] += 1

    def _prefill(self, prompt: torch.Tensor, length: int, slot: int,
                 row: torch.Tensor, embeds: torch.Tensor | None = None) -> None:
        logits, _ = self.model.prefill(prompt, length, self.cache, slot, row, embeds=embeds)
        window_set_slot(self.window, self.wlen, self.counts, slot, prompt, 0, length,
                        self.sampling.repeat_last_n[slot], self.cfg.vocab_size)
        self._activate(slot, logits)

    def _prefill_chunk(self, chunk: torch.Tensor, start: int, length: int, slot: int,
                       row: torch.Tensor, is_final: bool,
                       embeds: torch.Tensor | None = None) -> None:
        """One chunk of an admitting slot on its own (ragged attention off);
        the final chunk samples the slot's first token and activates it."""
        logits, _ = self.model.prefill_chunk(chunk, start, length, self.cache, slot, row,
                                             embeds=embeds)
        window_set_slot(self.window, self.wlen, self.counts, slot, chunk, start, length,
                        self.sampling.repeat_last_n[slot], self.cfg.vocab_size)
        if is_final:  # intermediate chunks' samples are discarded
            self._activate(slot, logits)

    def _mixed_chunk(self, chunk: torch.Tensor, start: int, length: int, slot: int,
                     row: torch.Tensor, is_final: bool,
                     embeds: torch.Tensor | None = None) -> torch.Tensor:
        """One mixed step: the admitting slot's chunk plus a decode token for
        every slot active at entry. Returns the [2, S] block (row 0 = input
        tokens, row 1 = this step's decode samples)."""
        sp, vocab = self.sampling, self.cfg.vocab_size
        tokens_in = self.tokens.clone()
        active_in = self.active.clone()
        chunk_logits, dec_logits, _ = self.model.mixed_step(
            chunk, start, length, slot, row, tokens_in, self.cache, active_in, embeds=embeds)
        window_set_slot(self.window, self.wlen, self.counts, slot, chunk, start, length,
                        sp.repeat_last_n[slot], vocab)
        if is_final:  # intermediate chunks' samples are discarded
            self._activate(slot, chunk_logits)
        sampled = sample_tokens(dec_logits, sp, self.counts, noise=self._noise())
        self.tokens = torch.where(active_in, sampled, self.tokens)
        window_push(self.window, self.wlen, self.counts, self.tokens, active_in,
                    sp.repeat_last_n, vocab)
        sp.step += active_in.to(sp.step.dtype)
        return torch.stack([tokens_in, self.tokens])

    def _decode_block(self, k: int) -> torch.Tensor:
        """k decode steps for all slots. Returns [k+1, S] tokens: row 0 is
        the block's input (a newly admitted slot's prefill sample), rows
        1..k the block's samples."""
        sp, vocab = self.sampling, self.cfg.vocab_size
        rows = [self.tokens.clone()]
        for _ in range(k):
            logits, _ = self.model.decode_step(self.tokens, self.cache, self.active)
            sampled = sample_tokens(logits, sp, self.counts, noise=self._noise())
            self.tokens = torch.where(self.active, sampled, self.tokens)
            window_push(self.window, self.wlen, self.counts, self.tokens, self.active,
                        sp.repeat_last_n, vocab)
            sp.step += self.active.to(sp.step.dtype)
            rows.append(self.tokens)
        return torch.stack(rows)

    def _verify_block(self, drafts: torch.Tensor, dlen: torch.Tensor) -> torch.Tensor:
        """One speculative verify step for all slots: [S, K] drafts (dlen
        [S] valid per slot) after each slot's committed last token, one
        batched forward, accept/reject, and the length commit. Returns
        [K+3, S]: row 0 the block's input tokens (a newly admitted slot's
        prefill sample), rows 1..K+1 the emitted tokens (valid up to
        n_emit per slot), and the last row n_emit."""
        sp, vocab = self.sampling, self.cfg.vocab_size
        cand = torch.cat([self.tokens[:, None], drafts], dim=1)
        logits, _ = self.model.verify_step(cand, self.cache, self.active)
        out, n_emit, last = spec_accept(logits, cand, dlen, sp, self.counts, self.window,
                                        self.wlen, self.active, vocab, noise=self._noise())
        self.tokens = torch.where(self.active, last, self.tokens)
        # commit the accepted length: the rejected candidate rows roll back
        rollback_to_length(self.cache, torch.clamp(self.cache.lengths + n_emit,
                                                   max=self.cache.max_context))
        return torch.cat([cand[:, :1].T, out, n_emit[None].to(out.dtype)])

    def _verify_tree_block(self, drafts: torch.Tensor, valid: torch.Tensor,
                           tree: tuple | None = None) -> torch.Tensor:
        """One tree verify step for all slots: [S, N-1] drafted node tokens
        (topological order after each slot's committed last token, the
        root) and [S, N] node validity, one tree-masked forward, the accept
        walk, the compaction of each accepted path's K/V rows and the length
        commit. `tree`: (parents, depths, ancestor mask), default the
        engine's. Returns [N+2, S]: row 0 the input tokens, rows 1..N the
        emitted tokens (valid up to n_emit per slot), the last row n_emit."""
        sp, vocab = self.sampling, self.cfg.vocab_size
        parents, depths, anc = tree or self._tree
        cand = torch.cat([self.tokens[:, None], drafts], dim=1)
        logits, _ = self.model.verify_step(cand, self.cache, self.active,
                                           tree_pos=depths, tree_mask=anc)
        out, path, n_emit, last = spec_accept_tree(
            logits, cand, parents, valid, sp, self.counts, self.window, self.wlen,
            self.active, vocab, noise=self._noise())
        self.tokens = torch.where(self.active, last, self.tokens)
        # the accepted path's rows move down over the optimistic rows, then
        # the lengths roll forward: rejected branches never reach host state
        commit_tree_path(self.cache, path, self.active)
        rollback_to_length(self.cache, torch.clamp(self.cache.lengths + n_emit,
                                                   max=self.cache.max_context))
        return torch.cat([cand[:, :1].T, out, n_emit[None].to(out.dtype)])

    # ------------------------------------------------------------ admission

    def submit(self, req: GenerationRequest) -> None:
        if self.embedding_only:
            self._fail(req, f"{self.cfg.name} is an embedding model; "
                            "it does not support generation", retryable=False)
            return
        if req.images and not self.cfg.vision:
            # the capability is per model: a loud refusal, never pixels ignored
            self._fail(req, f"{self.cfg.name} does not support image inputs",
                       retryable=False)
            return
        with self._lock:
            if len(self._pending) >= self.config.max_queue:
                raise RuntimeError("engine queue full")
            self._pending.append(req)
        with self._work:
            self._work.notify_all()

    def _tokenize(self, req: GenerationRequest) -> list[int]:
        if req.prompt_ids is not None:
            return list(req.prompt_ids)
        return self.tokenizer.encode(req.prompt or "", add_bos=not req.raw)

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _fail(self, req: GenerationRequest, msg: str, retryable: bool = True) -> None:
        res = GenerationResult(id=req.id, done_reason="error", error=msg,
                               retryable=retryable)
        if req.on_chunk:
            req.on_chunk("", True, res)

    def _try_admit(self) -> bool:
        """Admit one pending request into a free slot. Returns True if a
        request left the queue (caller loops until False)."""
        with self._lock:
            if not self._pending or not self._free_slots:
                return False
            req = self._pending.popleft()
        ids = self._tokenize(req)
        images = list(req.images or [])
        vc = self.cfg.vision_cfg
        # decode resume: the tokens a previous attempt generated join the
        # prompt for prefill and allocation (a cached prefix covers them)
        # but seed the slot's generated state below. Image requests never
        # resume: their KV holds spliced pixels that token ids do not address
        resume = [] if images else [int(t) for t in req.resume_ids or []]
        ids = ids + resume
        pixels = None
        if images:
            try:
                ids = self._expand_image_tokens(ids, len(images))
                pixels = preprocess_images(images, vc.image_size)
            except ValueError as e:
                self._fail(req, str(e), retryable=False)
                return True
        elif self.cfg.vision and req.prompt_ids is not None and vc and vc.image_token in ids:
            # an Ollama `context` of an image turn carries the expanded
            # image-token runs but not the pixels: prefilling placeholder
            # embeddings would answer about an image the model cannot see
            self._fail(req, "context contains image tokens; follow-ups on "
                            "image conversations must re-send the images", retryable=False)
            return True
        opts = req.options or {}
        num_ctx = int(opts.get("num_ctx") or 0)
        eff_ctx = min(num_ctx, self.max_context) if num_ctx > 0 else self.max_context
        eff_ctx = max(eff_ctx, 2)
        if len(ids) >= eff_ctx:
            ids = ids[-(eff_ctx - 1):]  # Ollama truncates from the left
            if images and ids.count(vc.image_token) != len(images) * vc.num_patches:
                # truncation cut into an image span: the splice would
                # misalign the patch rows
                self._fail(req, "context window too small for image inputs",
                           retryable=False)
                return True
        num_predict = int(opts.get("num_predict", -1))
        # resumed tokens are already in `ids`: reserve only the remaining
        # budget, so a resume reserves what the original admission did
        want = len(ids) + max(num_predict - len(resume), 0) if num_predict >= 0 else eff_ctx
        want = min(max(want, len(ids) + 1), eff_ctx)
        if not self.alloc.fits_slot_cap(want):
            self._fail(req, f"context {want} exceeds slot capacity")
            return True
        slot = self._free_slots[-1]
        # longest cached prefix first (pins the matched pages), then the rest;
        # image requests match nothing (token ids do not address pixels)
        with self._alloc_lock:
            cached = (self.alloc.match_prefix(slot, ids)
                      if self._prefix_cache_cap and not images else 0)
            if self.alloc.alloc(slot, want) is None:
                # pool exhausted: unpin, requeue at the front, wait for pages
                self.alloc.free(slot)
                with self._lock:
                    self._pending.appendleft(req)
                return False
        self._free_slots.pop()
        stop = opts.get("stop") or []
        stop_seqs = [stop] if isinstance(stop, str) else list(stop)
        st = _Slot(req, ids, want, num_predict, stop_seqs, self.tokenizer.eos_ids)
        if resume:
            # continue, don't restart: generated, text and the stop checks
            # pick up where the lost attempt stopped, and emission resumes
            # past the chars the client already has
            st.prompt_len = max(len(ids) - len(resume), 0)
            st.generated = list(resume)
            st.text = st.detok.delta(self.tokenizer, st.generated)
            st.emitted_len = max(int(req.resume_sent or 0), 0)
        seed = opts.get("seed")
        if seed is None:
            seed = self._rng.getrandbits(31)
        # repeat_last_n: -1 → the request's context size, 0 → disabled
        rl = int(opts.get("repeat_last_n", 64))
        if rl < 0:
            rl = want
        upd = {
            "temperature": float(opts.get("temperature", 0.8)),
            "top_k": int(opts.get("top_k", 40)),
            "top_p": float(opts.get("top_p", 0.9)),
            "min_p": float(opts.get("min_p", 0.0)),
            "repeat_penalty": float(opts.get("repeat_penalty", 1.1)),
            "repeat_last_n": min(rl, self.config.repeat_window),
            "seed": int(seed) & 0x7FFFFFFF,
            # the (seed, step) chain restarts at the draws the lost attempt
            # consumed
            "step": len(resume),
        }
        # a warm resume's match can cover resumed tokens too; cached_tokens
        # counts prompt tokens only
        st.cached_tokens = min(cached, st.prompt_len)
        row_list = self.alloc.table_row(slot)
        st.pages_held = len(row_list)
        t0 = time.perf_counter_ns()
        self._dispatch_prefill(slot, ids, row_list, upd, cached, pixels=pixels,
                               images=images or None)
        st.t_prefill_ns = time.perf_counter_ns() - t0
        st.joined_gen = self._gen + 1  # first block dispatched after this
        self._slots[slot] = st
        _TOKENS_TOTAL.inc(len(ids) - cached, model=self.cfg.name, kind="prefill")
        if cached:
            _TOKENS_TOTAL.inc(cached, model=self.cfg.name, kind="prefill_cached")
        self._update_kv_gauges()
        return True

    def _update_kv_gauges(self) -> None:
        """The page-pool gauges (pages used by live requests, free, parked in
        the reuse LRU) and the cumulative prefix-cache hit rate."""
        free, cached, name = self.alloc.free_pages, self.alloc.cached_pages, self.cfg.name
        _KV_PAGES_FREE.set(free, model=name)
        _KV_PAGES_CACHED.set(cached, model=name)
        # per-tier residency: hbm = reuse-LRU pages at pool bytes per page,
        # host = the encoded bytes the host tier holds
        bpp = (self.cache.k.nbytes + self.cache.v.nbytes) / max(self.config.num_pages, 1)
        tier = self.host_tier
        set_tier_gauges(name, cached, int(cached * bpp), tier.pages if tier else 0,
                        tier.bytes_used if tier else 0)
        _KV_PAGES_USED.set(self.config.num_pages - free - cached, model=name)
        total = self.alloc.hits + self.alloc.misses
        if total:
            _PREFIX_HIT_RATE.set(self.alloc.hits / total, model=name)

    def _expand_image_tokens(self, ids: list[int], n_images: int) -> list[int]:
        """Expand the image placeholders to num_patches image tokens each
        (the splice's contract, models/llava.py). A prompt with explicit
        placeholders (HF-style `<image>`) must hold one per image; a prompt
        without any (the Ollama API: images in a list beside the prompt)
        gets every image span first, after BOS; an already expanded prompt
        (an Ollama `context` of an image turn, images re-sent) is kept."""
        vc = self.cfg.vision_cfg
        if vc is None:
            raise ValueError(f"{self.cfg.name}: vision model without vision_cfg")
        tok, n = vc.image_token, vc.num_patches
        count = ids.count(tok)
        if count == 0:
            at = 1 if (ids and ids[0] == self.tokenizer.bos_id) else 0
            return ids[:at] + [tok] * (n * n_images) + ids[at:]
        if count == n_images * n:
            return list(ids)
        if count != n_images:
            raise ValueError(f"prompt has {count} image placeholder(s) for "
                             f"{n_images} image(s)")
        out: list[int] = []
        for t in ids:
            out.extend([tok] * n if t == tok else [t])
        return out

    def _image_embeds(self, pixels: np.ndarray) -> torch.Tensor:
        """Preprocessed images [n, 3, S, S] → their projected patch rows,
        flattened in prompt order [n·N, E]."""
        emb = self.model.encode_images(torch.from_numpy(pixels).to(self.device, self.dtype))
        return emb.reshape(-1, emb.shape[-1])

    def _record(self, rec: dict[str, Any]) -> None:
        """Hand one plan record to the sink (a worker group's liaison), under
        dispatch_lock, before the dispatch it describes."""
        if self.plan_sink is not None:
            self.plan_sink(rec)

    def _dispatch_prefill(self, slot: int, ids: list[int], row_list: list[int],
                          upd: dict[str, Any], cached: int,
                          pixels: np.ndarray | None = None,
                          images: list[str] | None = None) -> None:
        """The device half of admission: sampler row update and prefill.
        `cached` (page-aligned) prompt tokens already have KV pages in
        `row_list`: they skip the model and only seed the penalty window.
        With `pixels` (preprocessed from `images`) the images are encoded
        once and every prefill call takes its span's spliced embeddings.
        A long prompt's chunks (mixed steps or prefill_chunk calls) are all
        part of this one dispatch, and of its one plan record."""
        with self.dispatch_lock:
            # snapshot the ids: the list is also _Slot.ids, which grows
            rec = {"op": "admit", "slot": slot, "ids": list(ids), "row": list(row_list),
                   "sp": dict(upd), "cached": cached}
            if images:  # the follower preprocesses the same bytes itself
                rec["images"] = list(images)
            self._record(rec)
            self._prefill_slot(slot, ids, row_list, upd, cached, pixels)

    def _prefill_slot(self, slot: int, ids: list[int], row_list: list[int],
                      upd: dict[str, Any], cached: int, pixels: np.ndarray | None) -> None:
        self.sampling.set_slot(slot, upd)
        self._temps[slot] = upd["temperature"]
        row = torch.tensor(row_list, dtype=torch.int32, device=self.device)
        img_flat = self._image_embeds(pixels) if pixels is not None else None

        def spliced(tokens: torch.Tensor, offset: int) -> torch.Tensor | None:
            if img_flat is None:
                return None
            return self.model.splice_embeds(tokens, img_flat, offset)

        if cached or len(ids) > self._chunk_len:
            c = self._chunk_len
            rl = self.sampling.repeat_last_n[slot]
            for s0 in range(0, cached, c):
                part = ids[s0:min(s0 + c, cached)]
                window_set_slot(self.window, self.wlen, self.counts, slot,
                                self._ids_tensor(part, c), s0, len(part), rl,
                                self.cfg.vocab_size)
            img_tok = self.cfg.vision_cfg.image_token if img_flat is not None else None
            for s0 in range(cached, len(ids), c):
                part = ids[s0:s0 + c]
                chunk = self._ids_tensor(part, c)
                # the chunk's splice starts past the image tokens before it
                embeds = spliced(chunk, ids[:s0].count(img_tok))
                args = (chunk, s0, len(part), slot, row, s0 + c >= len(ids), embeds)
                if self.model.ragged_attention:
                    self._dispatch_mixed_chunk(*args)
                else:
                    self._prefill_chunk(*args)
        else:
            padded = self._ids_tensor(ids, self._bucket_for(len(ids)))
            self._prefill(padded, len(ids), slot, row, embeds=spliced(padded, 0))

    # ------------------------------------------------------------ stepping

    def _enqueue(self, out: torch.Tensor, k: int) -> None:
        """Start the block's copy to the host and queue it for ingest."""
        event = None
        if out.is_cuda:
            out = out.to("cpu", non_blocking=True)  # pinned, asynchronous
            event = torch.cuda.Event()
            event.record()
        self._inflight.append((self._gen, out, event, k, time.perf_counter()))

    def _dispatch_block(self, k: int) -> None:
        _BATCH_OCCUPANCY.observe(len(self._slots), model=self.cfg.name)
        self._gen += 1
        t0 = time.perf_counter()
        with self.dispatch_lock:
            self._record({"op": "block", "k": k})
            out = self._decode_block(k)
        # the launches' host wall: the device keeps computing after
        DISPATCH_SECONDS.observe(time.perf_counter() - t0, model=self.cfg.name)
        self._enqueue(out, k)

    def _dispatch_mixed_chunk(self, chunk: torch.Tensor, start: int, length: int,
                              slot: int, row: torch.Tensor, is_final: bool,
                              embeds: torch.Tensor | None = None) -> None:
        self._gen += 1
        t0 = time.perf_counter()
        out = self._mixed_chunk(chunk, start, length, slot, row, is_final, embeds)
        DISPATCH_SECONDS.observe(time.perf_counter() - t0, model=self.cfg.name)
        self._enqueue(out, 1)

    def _fetch_oldest(self) -> None:
        """Wait for the oldest in-flight block's tokens and ingest them;
        observes the device pace and the per-step fetch + ingest wall."""
        gen, host, event, k, t_disp = self._inflight.popleft()
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        self._observe_device_step(t_disp, k)
        self._ingest_block(gen, host.numpy())
        _STEP_DURATION.observe((time.perf_counter() - t0) / max(k, 1), model=self.cfg.name)

    def _observe_device_step(self, t_disp: float, k: int) -> None:
        """Per-step device time estimate, the JAX engine's: with another
        block in flight when this fetch completed, the device never idled
        between blocks, so consecutive fetches pace at the block's time;
        otherwise dispatch-to-fetch wall is the upper bound. The block's
        time is split evenly over the slots that shared it (usage
        attribution)."""
        now = time.perf_counter()
        prev, self._t_prev_fetch = self._t_prev_fetch, now
        dev = (now - (prev if prev is not None and self._inflight else t_disp)) / max(k, 1)
        DEVICE_STEP_SECONDS.observe(dev, model=self.cfg.name)
        if self._slots:
            share = max(dev, 0.0) * max(k, 1) / len(self._slots)
            for st in self._slots.values():
                st.device_s += share

    def _ingest_block(self, gen: int, tok_np: np.ndarray) -> None:
        """Feed one fetched [k+1, S] block through per-token bookkeeping.
        Row 0 is consumed only by slots whose joined_gen == gen (their
        prefill sample); slots newer than the block are skipped."""
        k = tok_np.shape[0] - 1
        now = time.perf_counter_ns()
        wall = time.time()
        ingested = 0
        for slot, st in list(self._slots.items()):
            if st.joined_gen > gen:
                continue
            first_row = 0 if st.joined_gen == gen else 1
            if first_row == 0:
                st.t_prefill_ns = now - st.t_start
            if not st.t_first_decode:
                st.t_first_decode = now
            st.t_last_ingest = wall
            for r in range(first_row, k + 1):
                self._ingest(slot, st, int(tok_np[r, slot]))
                ingested += 1
                if slot not in self._slots:
                    break  # finished mid-block; later rows are post-finish junk
        if ingested:
            _TOKENS_TOTAL.inc(ingested, model=self.cfg.name, kind="decode")

    def _step_spec(self) -> None:
        """One speculative iteration: draft per slot from its host-visible
        history, dispatch the verify step, fetch it and ingest the ragged
        accept counts. Serial by construction: the next step's drafts
        depend on this step's tokens."""
        while self._inflight:
            # mixed admission blocks first: their tokens must be
            # host-visible before drafting
            self._fetch_oldest()
        k, n_slots = self._spec_k, self.config.max_slots
        if self._replays_drafts:
            raise RuntimeError("this rank replays the liaison's verify_tree records: a "
                               "group with a draft model runs through plan replay")
        if isinstance(self._drafter, DraftModelDrafter):
            self._step_spec_tree(k)
            return
        drafts = np.zeros((n_slots, k), np.int32)
        dlen = np.zeros((n_slots,), np.int32)
        for slot, st in list(self._slots.items()):
            if st.joined_gen > self._gen:
                continue  # first token still device-side: nothing to extend
            prop = self._drafter.draft(st.ids, k)
            if prop and st.num_predict >= 0:
                # never draft past num_predict: the host would discard it
                prop = prop[:max(st.num_predict - len(st.generated) - 1, 0)]
            if prop:
                dlen[slot] = len(prop)
                drafts[slot, :len(prop)] = prop
        _BATCH_OCCUPANCY.observe(len(self._slots), model=self.cfg.name)
        self._gen += 1
        t0 = time.perf_counter()
        out = self._dispatch_verify(drafts, dlen)
        self._fetch_verify(out, t0, dlen)

    def _dispatch_verify(self, drafts: np.ndarray, dlen: np.ndarray) -> torch.Tensor:
        """One verify step of host drafts [S, K] (dlen [S] valid each)."""
        with self.dispatch_lock:
            self._record({"op": "verify", "drafts": drafts.tolist(), "dlen": dlen.tolist()})
            return self._verify_block(torch.from_numpy(drafts).to(self.device),
                                      torch.from_numpy(dlen).to(self.device))

    def _fetch_verify(self, out: torch.Tensor, t_disp: float, dlen: np.ndarray) -> None:
        """The spec path's one fetch per step and its ragged ingest."""
        t0 = time.perf_counter()
        DISPATCH_SECONDS.observe(t0 - t_disp, model=self.cfg.name)
        host = out.cpu().numpy()
        self._observe_device_step(t_disp, 1)
        self._ingest_spec(self._gen, host[:-1], host[-1], dlen)
        _STEP_DURATION.observe(time.perf_counter() - t0, model=self.cfg.name)

    def _step_spec_tree(self, k: int) -> None:
        """One draft-model tree iteration: one batched draft pass over every
        live slot, one tree verify step, its fetch and the ragged ingest.
        The per-slot budgets are the JAX engine's: no chain past
        num_predict, and siblings only where a depth-1 chain would fit."""
        width = self._tree_width
        n, n_slots = len(self._tree[0]), self.config.max_slots
        drafts = np.zeros((n_slots, n - 1), np.int32)
        valid = np.zeros((n_slots, n), bool)
        dlen = np.zeros((n_slots,), np.int32)
        todo: dict[int, list[int]] = {}
        budget: dict[int, int] = {}
        for slot, st in list(self._slots.items()):
            if st.joined_gen > self._gen:
                continue  # first token still device-side: nothing to extend
            # accepting the whole depth-b chain plus the bonus token lands
            # exactly on the remaining allowance
            b = k if st.num_predict < 0 else max(st.num_predict - len(st.generated) - 1, 0)
            todo[slot] = st.ids
            budget[slot] = b
            # every live slot verifies at least its root: a slot the drafter
            # skips still emits its one corrected token, a plain decode step
            valid[slot, 0] = True
        props = self._drafter.draft_batch(todo, k, width) if todo else {}
        self.spec_stats["draft_ns"] = self._drafter.draft_ns
        for slot, (chain, alts) in props.items():
            b = budget[slot]
            depth = min(len(chain), b)
            drafts[slot, :depth] = chain[:depth]
            valid[slot, 1:1 + depth] = True
            if b >= 1 and k >= 1:
                # a sibling emits at most itself and a bonus token, the
                # bound of a depth-1 chain
                for j, a in enumerate(alts):
                    drafts[slot, k + j] = a
                    valid[slot, k + 1 + j] = True
            # proposed = chain depth, as the chain drafters count it (the
            # siblings are a second chance, not more proposals)
            dlen[slot] = depth
        _BATCH_OCCUPANCY.observe(len(self._slots), model=self.cfg.name)
        self._gen += 1
        t0 = time.perf_counter()
        out = self._dispatch_verify_tree(drafts, valid, self._tree[0])
        self._fetch_verify(out, t0, dlen)

    def _dispatch_verify_tree(self, drafts: np.ndarray, valid: np.ndarray,
                              parents) -> torch.Tensor:
        """One tree verify step of host drafts [S, N-1] and validity [S, N]
        over the topology `parents`; the record carries the topology, so a
        follower replays the same program whatever its own settings (the
        JAX engine's verify_tree record)."""
        parents = np.asarray(parents, np.int32)
        tree = self._tree if np.array_equal(parents, self._tree[0]) else (
            parents, tree_depths(parents), tree_ancestor_mask(parents))
        with self.dispatch_lock:
            self._record({"op": "verify_tree", "drafts": drafts.tolist(),
                          "valid": valid.tolist(), "parents": parents.tolist()})
            return self._verify_tree_block(torch.from_numpy(drafts).to(self.device),
                                           torch.from_numpy(valid).to(self.device), tree)

    def _ingest_spec(self, gen: int, tok_np: np.ndarray, n_emit: np.ndarray,
                     dlen: np.ndarray) -> None:
        """Ragged ingest of one verify step: per slot, rows 1..n_emit[slot]
        of the [K+2, S] block are emitted tokens (row 0 is a just-admitted
        slot's prefill sample); later rows are rejected drafts and never
        reach host state. Stops, EOS and num_predict run per token in
        _ingest, so a stop inside an accepted span truncates exactly as the
        sequential path would."""
        now = time.perf_counter_ns()
        wall = time.time()
        emitted = proposed = accepted = ingested = 0
        for slot, st in list(self._slots.items()):
            if st.joined_gen > gen:
                continue
            first_row = 0 if st.joined_gen == gen else 1
            if first_row == 0:
                st.t_prefill_ns = now - st.t_start
            if not st.t_first_decode:
                st.t_first_decode = now
            st.t_last_ingest = wall
            n, prop = int(n_emit[slot]), int(dlen[slot])
            acc = max(n - 1, 0)
            st.spec_proposed += prop
            st.spec_accepted += acc
            proposed += prop
            accepted += acc
            for r in range(first_row, min(n, tok_np.shape[0] - 1) + 1):
                self._ingest(slot, st, int(tok_np[r, slot]))
                ingested += 1
                emitted += r >= 1  # row 0 is a prefill sample, not verify output
                if slot not in self._slots:
                    break  # finished mid-span; later rows are post-stop junk
        m, dk = self.cfg.name, self._drafter.kind
        if ingested:
            _TOKENS_TOTAL.inc(ingested, model=m, kind="decode")
        if proposed:
            _SPEC_PROPOSED.inc(proposed, model=m, drafter=dk)
            _SPEC_ACCEPT_RATE.observe(accepted / proposed, model=m, drafter=dk)
        if accepted:
            _SPEC_ACCEPTED.inc(accepted, model=m, drafter=dk)
        if proposed - accepted:
            _SPEC_REJECTED.inc(proposed - accepted, model=m, drafter=dk)
        stats = self.spec_stats
        stats["steps"] += 1
        stats["proposed"] += proposed
        stats["accepted"] += accepted
        stats["emitted"] += emitted

    def _ingest(self, slot: int, st: _Slot, tok: int) -> None:
        """Record one sampled token; emit text; finish the slot if done."""
        if st.export_only:
            # disaggregated prefill: the first host-visible token proves the
            # whole prompt's KV is written. Finish now with reason "export",
            # so _finish registers the prompt's full pages in the prefix
            # cache (the export source). The token is not detokenized or
            # streamed: the decode worker re-prefills the prompt's tail and
            # samples it itself, which keeps the streams identical
            st.generated.append(tok)
            st.ids.append(tok)
            self._finish(slot, st, "export")
            return
        st.generated.append(tok)
        st.ids.append(tok)
        done_reason = None
        if tok in st.eos_ids:
            st.generated.pop()  # EOS is not part of the visible output
            st.ids.pop()
            done_reason = "stop"
        else:
            st.text += st.detok.delta(self.tokenizer, st.generated)
            for s in st.stop_seqs:  # stop sequences: trim at the first match
                i = st.text.find(s)
                if i >= 0:
                    st.text = st.text[:i]
                    done_reason = "stop"
                    break
        if done_reason is None:
            if 0 <= st.num_predict <= len(st.generated):
                done_reason = "length"
            elif st.prompt_len + len(st.generated) >= st.capacity:
                done_reason = "length"
        if done_reason is not None:
            self._finish(slot, st, done_reason)
            return
        # the token survived (a verify's rejected drafts never reach here):
        # write the resume watermark at the request's cadence. A finishing
        # token is left out, so a resume always has a token left to make
        cadence = st.req.snapshot_every
        if cadence > 0 and len(st.generated) % cadence == 0:
            st.snapshot = (list(st.generated), st.text)
        # emit finalized text only: hold back what may become a stop sequence
        safe = len(st.text) - st.holdback()
        if safe > st.emitted_len and st.req.on_chunk:
            delta = st.text[st.emitted_len:safe]
            st.emitted_len = safe
            st.req.on_chunk(delta, False, None)

    def _finish(self, slot: int, st: _Slot, reason: str, error: str = "") -> None:
        now = time.perf_counter_ns()
        last_delta = st.text[st.emitted_len:]
        st.emitted_len = len(st.text)
        res = GenerationResult(
            id=st.req.id, error=error, text=st.text, token_ids=list(st.generated),
            context=list(st.ids), done_reason=reason, prompt_eval_count=st.prompt_len,
            cached_tokens=st.cached_tokens, prompt_eval_duration_ns=st.t_prefill_ns,
            eval_count=len(st.generated),
            eval_duration_ns=(now - st.t_first_decode) if st.t_first_decode else 0,
            load_duration_ns=self.load_duration_ns, total_duration_ns=now - st.t_start,
            spec_proposed=st.spec_proposed, spec_accepted=st.spec_accepted,
            decode_device_s=st.device_s,
            kv_page_s=max(st.pages_held, 1) * max(time.time() - st.t_admit_wall, 0.0),
        )
        self._deactivate(slot)
        # register the full pages of the final context for reuse, minus the
        # last token (its KV is written only when it is input to a step that
        # may never have been dispatched); an error finish registers nothing,
        # nor does an image request (its KV holds spliced pixels that the
        # image-token ids do not address)
        register = reason != "error" and not st.req.images
        with self._alloc_lock:
            self.alloc.free(slot, st.ids[:-1] if register else None)
        self._update_kv_gauges()
        del self._slots[slot]
        self._free_slots.append(slot)
        if isinstance(self._drafter, DraftModelDrafter):
            # the next request in this slot drafts from scratch
            self._drafter.reset_slot(slot)
        if st.req.on_chunk:
            st.req.on_chunk(last_delta, True, res)

    def _deactivate(self, slot: int) -> None:
        """A finished slot leaves the device batch."""
        with self.dispatch_lock:
            self._record({"op": "deact", "slot": slot})
            self.active[slot] = False
            self._temps.pop(slot, None)

    def _drain_ctl(self) -> None:
        while self._ctl:
            op, req_id = self._ctl.popleft()
            if op == "call":
                fn, done, err = req_id
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — raised in the caller
                    err.append(e)
                done.set()
                continue
            for slot, st in list(self._slots.items()):
                if st.req.id == req_id:
                    self._finish(slot, st, op)
                    break

    def step(self) -> bool:
        """One synchronous iteration: admit what fits, one decode step for
        all active slots, fetch and ingest (block size 1, no pipelining).
        Returns False when idle."""
        self._drain_ctl()
        while self._try_admit():
            pass
        while self._inflight:  # mixed admission steps queued [2, S] blocks
            self._fetch_oldest()
        if not self._slots:
            self._t_prev_fetch = None
            return bool(self._pending)
        if self._spec_k:
            self._step_spec()
            return True
        self._dispatch_block(1)
        self._fetch_oldest()
        return True

    # ------------------------------------------------------------- runner

    def start(self) -> None:
        """Start the engine thread, which owns all device dispatch from then
        on; submit() and cancel() are the cross-thread entry points. Refuses
        while a profiler capture that profile() did not start is active."""
        if self._runner is not None or self.embedding_only:
            return   # an embedding-only engine runs each embed on its caller
        if self._foreign_capture():
            raise RuntimeError(_FOREIGN_CAPTURE)
        self._runner_stop.clear()
        self._runner = threading.Thread(target=self._run, name=f"engine-{self.cfg.name}",
                                        daemon=True)
        self._runner.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._runner_stop.set()
        with self._work:
            self._work.notify_all()
        r = self._runner
        if r is not None:
            r.join(timeout)
            if not r.is_alive():
                self._runner = None

    @property
    def running(self) -> bool:
        return self._runner is not None and self._runner.is_alive()

    def _run(self) -> None:
        fail_streak = 0
        while not self._runner_stop.is_set():
            with self._work:
                while not (self._pending or self._slots or self._ctl
                           or self._runner_stop.is_set()):
                    self._work.wait(timeout=0.5)
            if self._runner_stop.is_set():
                break
            with _GATE.step():
                refuse = self._foreign_capture()
                if refuse:
                    # refuse to serve under it: a CUPTI thread can crash when
                    # a capture starts or stops while this thread launches
                    # kernels. A profile() start queued meanwhile fails here.
                    self._drain_ctl()
                    if self._pending or self._slots:
                        self._inflight.clear()
                        self.abort_all(_FOREIGN_CAPTURE)
                        self.reset_device_state()
                else:
                    try:
                        self._pump_once()
                        fail_streak = 0
                    except Exception as e:  # noqa: BLE001 — keep serving the others
                        self._inflight.clear()
                        self._t_prev_fetch = None
                        self.abort_all(f"engine failure: {e!r}")
                        self.reset_device_state()
                        fail_streak += 1
                        if fail_streak >= 3:
                            self.abort_all("engine unrecoverable")
                            return
            if refuse:
                self._runner_stop.wait(0.05)

    @staticmethod
    def _foreign_capture() -> bool:
        """A torch profiler is active that no engine's profile() started."""
        return _GATE.owner is None and torch.autograd.profiler._is_profiler_enabled

    def _between_steps(self, fn: Callable[[], None], deadline: float | None = None) -> None:
        """Run fn between two steps of this engine's runner thread (on this
        thread when no runner is live), with every runner of the process
        held between its steps and this engine's device idle, and wait for
        it; fn's exception is raised here. Past `deadline` (time.monotonic();
        None waits for ever) with fn not yet begun, TimeoutError: a runner
        stuck inside a step holds the gate's switch back."""
        def call():
            with _GATE.switch(deadline):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                fn()

        self._on_runner(call, deadline)

    def _on_runner(self, fn: Callable[[], Any], deadline: float | None = None,
                   inline: Callable[[], Any] | None = None) -> Any:
        """fn() run on this engine's runner thread between two of its steps
        (inside the runner's shared hold of the profile gate), waited for:
        its result returned, its exception raised here. With no live runner,
        or one that stopped before it, `inline` (default fn) runs on this
        thread instead. Past `deadline` (time.monotonic(); None waits for
        ever) with fn not yet begun, TimeoutError."""
        runner = self._runner
        if runner is None or not runner.is_alive():
            return (inline or fn)()
        box: list[Any] = []

        def call():
            box.append(fn())

        entry = ("call", (call, threading.Event(), []))
        _, (_, done, err) = entry
        with self._work:
            self._ctl.append(entry)
            self._work.notify_all()
        while not done.wait(0.5):
            if runner.is_alive():
                if deadline is not None and time.monotonic() > deadline:
                    with self._work:
                        queued = entry in self._ctl
                        if queued:
                            self._ctl.remove(entry)
                    if queued:   # the runner never came out of its step
                        raise TimeoutError("InferenceEngine.profile(): the runner "
                                           "stayed inside its step")
                continue
            with self._work:
                queued = entry in self._ctl
                if queued:   # never run it at a later start()
                    self._ctl.remove(entry)
            if queued:   # the runner stopped before it: run it here
                return (inline or fn)()
            if not done.is_set():
                raise RuntimeError("InferenceEngine: the runner thread stopped")
        if err:
            raise err[0]
        return box[0]

    @contextlib.contextmanager
    def profile(self, start_timeout_s: float | None = None,
                **kwargs) -> Iterator[torch.profiler.profile]:
        """A torch.profiler capture (`torch.profiler.profile(**kwargs)`) of
        the process while this engine serves, its runner thread live. The
        capture starts and stops on this engine's runner thread between two
        of its steps, with this engine's device idle and every runner thread
        of the process (other engines' too) held between its steps: a CUPTI
        thread segfaulted (a bad free) when a capture started or stopped on
        one thread while another launched kernels. Other engines keep
        serving under the capture. One capture at a time in the process: a
        second profile() raises. With `start_timeout_s`, a capture that
        cannot start within it (a runner of the process stuck inside a step)
        raises TimeoutError and leaves the runners serving.

        Runners refuse to serve under a torch.profiler capture that no
        engine's profile() started: each sees it at the start of its next
        step, fails its requests and waits for the capture to end. Such a
        capture started or stopped while a runner is inside a step can
        still crash; so can one started while a thread that drives step()
        itself, which the gate does not hold, launches kernels."""
        if not _GATE.claim.acquire(blocking=False):
            raise RuntimeError("InferenceEngine.profile(): another capture is active")
        try:
            prof = torch.profiler.profile(**kwargs)

            def begin():
                if torch.autograd.profiler._is_profiler_enabled:
                    raise RuntimeError(_FOREIGN_CAPTURE)
                prof.start()
                _GATE.owner = self

            def end():
                _GATE.owner = None
                prof.stop()

            self._between_steps(begin, None if start_timeout_s is None
                                else time.monotonic() + start_timeout_s)
            try:
                yield prof
            finally:
                self._between_steps(end)
        finally:
            _GATE.claim.release()

    def _pump_once(self) -> None:
        """One runner iteration: bounded admission, top up the dispatch
        pipeline, fetch and ingest the oldest in-flight block."""
        self._drain_ctl()
        budget = self.config.admit_per_block if self._slots else self.config.max_slots
        admitted = 0
        while admitted < budget and self._try_admit():
            admitted += 1
        if admitted:
            # a prefill ran between decode blocks: the next fetch delta would
            # book its wall as device pace; dispatch-to-fetch it is instead
            self._t_prev_fetch = None
        if not self._slots:
            while self._inflight:
                self._fetch_oldest()
            self._t_prev_fetch = None
            self._t_ingest_done = None
            return
        k = 1 if self._spec_k else self.config.decode_block
        if self._t_ingest_done is not None:
            # host gap since the previous ingest (control drain, admission,
            # stream callbacks), per fused step as the device series reads
            HOST_SCHED_SECONDS.observe((time.perf_counter() - self._t_ingest_done) / k,
                                       model=self.cfg.name)
        if self._spec_k:  # one verify step per iteration, fetched at once
            self._step_spec()
        else:
            while len(self._inflight) < max(1, self.config.pipeline_depth):
                self._dispatch_block(k)
            self._fetch_oldest()
        self._t_ingest_done = time.perf_counter()

    # ---------------------------------------------------------- public API

    def generate(self, req: GenerationRequest) -> GenerationResult:
        """Submit and wait until THIS request is done: with the runner
        active just wait, otherwise drive step() inline."""
        box: list[GenerationResult] = []
        done_evt = threading.Event()
        user_cb = req.on_chunk

        def cb(delta: str, done: bool, res: GenerationResult | None):
            if user_cb:
                user_cb(delta, done, res)
            if done and res is not None:
                box.append(res)
                done_evt.set()

        req.on_chunk = cb
        self.submit(req)
        if self.running:
            done_evt.wait()
            return box[0]
        while not box:
            if not self.step() and not box:
                time.sleep(0.001)
        return box[0]

    def abort_all(self, msg: str) -> int:
        """Fail every pending and active request."""
        n = 0
        with self._lock:
            pending, self._pending = list(self._pending), deque()
        for r in pending:
            self._fail(r, msg)
            n += 1
        for slot, st in list(self._slots.items()):
            self._finish(slot, st, "error", error=msg)
            n += 1
        return n

    # batch-size buckets of the embeddings path: a bounded set of shapes
    _EMBED_BATCH_BUCKETS = (1, 4, 16, 32)

    def _batch_bucket(self, n: int) -> int:
        for b in self._EMBED_BATCH_BUCKETS:
            if n <= b:
                return b
        return self._EMBED_BATCH_BUCKETS[-1]

    def embed(self, texts: list[str]) -> list[list[float]]:
        """Pooled, L2-normalized embeddings of `texts` (callable from any
        thread). bert_embed models run the bidirectional encoder with their
        configured pooling (mean or cls); decoder families mean-pool their
        final hidden states. The texts are grouped by length bucket and run
        up to `embed_batch` per forward, each row with its own valid length
        (attention and pooling mask the padding); padding rows get length 1
        and their outputs are dropped. Each batch runs on the runner thread
        between two of its steps when the runner is live, else on this
        thread holding the profile gate as a step does; under a profiler
        capture that no engine's profile() started it raises."""
        enc = [self.tokenizer.encode_for_embedding(t, self.max_context) for t in texts]
        out: list[list[float] | None] = [None] * len(texts)
        by_bucket: dict[int, list[int]] = {}
        for i, ids in enumerate(enc):
            by_bucket.setdefault(self._bucket_for(max(len(ids), 1)), []).append(i)
        cap = max(1, self.config.embed_batch)
        for blen, idxs in sorted(by_bucket.items()):
            for start in range(0, len(idxs), cap):
                group = idxs[start:start + cap]
                bsz = min(self._batch_bucket(len(group)), cap)
                tok = np.zeros((bsz, blen), np.int32)
                lens = np.ones((bsz,), np.int32)
                for j, i in enumerate(group):
                    tok[j, :len(enc[i])] = enc[i]
                    lens[j] = max(len(enc[i]), 1)
                vecs = self._embed_call(tok, lens)
                for j, i in enumerate(group):
                    out[i] = vecs[j].tolist()
        return out  # type: ignore[return-value]

    def _embed_batch(self, tok: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """One embedding forward: [B, T] ids, [B] lengths → [B, E] float32
        unit vectors on the host."""
        from gridllm_torch.models.bert_embed import pool

        with self.dispatch_lock:
            self._record({"op": "embed", "tok": tok.tolist(), "lens": lens.tolist()})
            lens_t = torch.from_numpy(lens).to(self.device)
            h = self.model.hidden_states(torch.from_numpy(tok).to(self.device), lens_t)
            vecs = pool(h, lens_t, self.cfg.pooling)
        return vecs.cpu().numpy()

    def apply_plan_op(self, rec: dict[str, Any]) -> None:
        """A follower's replay of one liaison plan record (see the module
        docstring). Call in record order from ONE thread; the follower's
        runner is never started, and it never reads a result back."""
        op = rec["op"]
        if op == "admit":
            images = list(rec.get("images") or [])
            pixels = (preprocess_images(images, self.cfg.vision_cfg.image_size)
                      if images else None)
            self._dispatch_prefill(int(rec["slot"]), [int(i) for i in rec["ids"]],
                                   [int(p) for p in rec["row"]], dict(rec["sp"]),
                                   int(rec.get("cached", 0)), pixels=pixels)
            self._inflight.clear()   # a long prompt's mixed steps: never fetched
        elif op == "block":
            self._dispatch_block(int(rec["k"]))
            self._inflight.clear()
        elif op == "verify":
            # drafts are plain host ints in the record: the same program
            self._dispatch_verify(np.asarray(rec["drafts"], np.int32),
                                  np.asarray(rec["dlen"], np.int32))
        elif op == "verify_tree":
            self._dispatch_verify_tree(np.asarray(rec["drafts"], np.int32),
                                       np.asarray(rec["valid"], bool), rec["parents"])
        elif op == "deact":
            self._deactivate(int(rec["slot"]))
        elif op == "embed":
            self._embed_batch(np.asarray(rec["tok"], np.int32), np.asarray(rec["lens"], np.int32))
        elif op == "reset":
            self.reset_device_state()
        else:
            raise ValueError(f"unknown plan op: {op!r}")

    def _embed_call(self, tok: np.ndarray, lens: np.ndarray) -> np.ndarray:
        def guarded():
            if self._foreign_capture():
                raise RuntimeError(_FOREIGN_CAPTURE)
            return self._embed_batch(tok, lens)

        def inline():
            with self._embed_lock, _GATE.step():
                return guarded()

        return self._on_runner(guarded, inline=inline)

    def resolve_seed(self) -> int:
        """A sampler seed from the engine-seeded RNG, the stream admission
        draws from for unseeded requests: a worker resolves the seed before
        submitting so its resume watermark can carry it."""
        return int(self._rng.getrandbits(31))

    def _request_finish(self, req_id: str, op: str) -> bool:
        """Finish a pending or running request with done_reason `op`. A
        pending one leaves the queue here; a running slot finishes at the
        driving thread's next block boundary (only that thread touches
        device state)."""
        with self._lock:
            for i, r in enumerate(self._pending):
                if r.id == req_id:
                    del self._pending[i]
                    if r.on_chunk:
                        r.on_chunk("", True, GenerationResult(id=req_id, done_reason=op))
                    return True
        for st in list(self._slots.values()):
            if st.req.id == req_id:
                self._ctl.append((op, req_id))
                if not self.running:
                    self._drain_ctl()
                else:
                    with self._work:
                        self._work.notify_all()
                return True
        return False

    def cancel(self, req_id: str) -> bool:
        """Cancel a pending or running request; its on_chunk gets a final
        done with done_reason 'cancel'."""
        return self._request_finish(req_id, "cancel")

    def suspend(self, req_id: str) -> bool:
        """Suspend a pending or running request for a drain or a preemption:
        it finishes with done_reason 'suspend' and a result that carries what
        a resume needs (context, generated ids, text); its pages register in
        the prefix cache as on a normal finish. A pending request suspends
        with nothing generated."""
        return self._request_finish(req_id, "suspend")

    def decode_snapshot(self, req_id: str) -> dict[str, Any] | None:
        """The last resume watermark of a running request, ``{"tokens":
        [...generated ids...], "text": "..."}``, or None before the first.
        A lock-free read of the engine thread's atomic tuple."""
        for st in list(self._slots.values()):
            if st.req.id == req_id:
                snap = st.snapshot
                if snap is None:
                    return None
                toks, text = snap
                return {"tokens": list(toks), "text": text}
        return None

    @property
    def free_slot_count(self) -> int:
        return 0 if self.embedding_only else len(self._free_slots)

    @property
    def active_requests(self) -> int:
        return len(self._slots)

    @property
    def queued_requests(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------ KV movement

    def _build_host_tier(self) -> HostKVTier | None:
        """The host KV tier behind the prefix cache's reuse LRU, or None
        (capacity 0, or the prefix cache off: the spill unit is a cached
        page)."""
        c = self.config
        cap = c.kv_host_bytes if c.kv_host_bytes is not None else env_int("GRIDLLM_KV_HOST_BYTES")
        if cap <= 0:
            return None
        if self._prefix_cache_cap == 0 or self.mesh is not None:
            log.info("host KV tier disabled for %s: needs the prefix cache and an "
                     "unsharded pool (prefix cache %s, meshed %s)", c.model,
                     self._prefix_cache_cap != 0, self.mesh is not None)
            return None
        spill_int8 = (c.kv_spill_int8 if c.kv_spill_int8 is not None
                      else env_bool("GRIDLLM_KV_SPILL_INT8"))
        log.info("host KV tier enabled for %s: %d bytes, spill %s", c.model, cap,
                 "int8-page" if spill_int8 else "raw")
        return HostKVTier(cap, model=self.cfg.name, spill_int8=spill_int8)

    @property
    def _kv_int8(self) -> bool:
        return isinstance(self.cache.k, QuantPages)

    def _kv_layout(self) -> str:
        """The wire's kvLayout label, the one the JAX engine writes for the
        same attention mode (the port's pools are never lane-padded)."""
        return "ragged" if self.model.ragged_attention else "legacy"

    def _host_words(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor as a host numpy array in its wire form: bfloat16
        as its 16-bit words (numpy has no bfloat16)."""
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    def _device_pages(self, x: np.ndarray, dtype: str) -> torch.Tensor:
        """Host pages of wire dtype `dtype` (bfloat16 as uint16 words) as a
        device tensor of the pool's dtype."""
        x = np.ascontiguousarray(x)
        if dtype == "bfloat16":
            t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(x)
        return t.to(self.device).to(self.dtype)

    def kv_transfer_supported(self) -> bool:
        """Export and import need the content-addressed prefix cache: the
        transfer unit is cached pages."""
        return (not self.embedding_only and self._prefix_cache_cap != 0
                and self.mesh is None and self.plan_sink is None)

    def export_prefix_pages(self, token_ids: list[int]) -> dict[str, Any] | None:
        """Gather the longest cached full-page prefix of `token_ids` as host
        arrays for the migration wire. Returns {tokens, k, v, dtype, model,
        kvLayout, quant}, k/v [L, n, ps, KVH, D] in the wire dtype `dtype`
        (the engine's compute dtype, bfloat16 as uint16 words; an int8
        pool is dequantized, as the JAX engine does), or None when nothing
        is cached or transfer is unsupported.

        The pages are refcount-pinned while they are gathered, so no
        admission can evict or overwrite them. The gather is launched on
        the device's current stream, the default stream the runner's steps
        use too (the port sets no other), so it runs after every step
        launched before it, among them the steps that wrote these pages:
        a page is registered only after its owner finished, on the host,
        after those steps were launched."""
        if not self.kv_transfer_supported():
            return None
        alloc = self.alloc
        with self._alloc_lock:
            pages, tokens = alloc.pin_prefix(token_ids)
        if not pages:
            return None
        try:
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            k_pool, v_pool = self.cache.k, self.cache.v
            if self._kv_int8:
                # the wire carries the compute dtype, so fp and int8 pools
                # interoperate: dequantize on export, requantize on install
                k_dev = (k_pool.data[:, idx].float()
                         * k_pool.scale[:, idx][..., None, None]).to(self.dtype)
                v_dev = (v_pool.data[:, idx].float()
                         * v_pool.scale[:, idx][..., None, None]).to(self.dtype)
            else:
                k_dev, v_dev = k_pool[:, idx], v_pool[:, idx]
            k, v = self._host_words(k_dev), self._host_words(v_dev)
        finally:
            with self._alloc_lock:
                alloc.unpin_pages(pages)
        return {
            "tokens": [int(t) for t in token_ids[:tokens]],
            "k": k, "v": v, "dtype": self.config.dtype,
            "model": self.cfg.name,
            "kvLayout": self._kv_layout(),
            "quant": self.config.quantize,
        }

    def import_prefix_pages(self, token_ids: list[int], k: np.ndarray, v: np.ndarray,
                            meta: dict[str, Any]) -> int:
        """Install migrated KV pages (wire dtype `meta["dtype"]`, bfloat16
        as uint16 words) into the pool and register them in the prefix
        cache, so the request's admission here shares them through the
        normal match_prefix warm path. Returns the tokens installed
        (contiguous from position 0; fewer than offered under pool
        pressure). Raises on a geometry or dtype mismatch; the sender takes
        that as a NACK and serves the request itself."""
        if not self.kv_transfer_supported():
            raise ValueError(f"{self.cfg.name}: KV import unsupported here (prefix cache off)")
        mc, c = self.cfg, self.config
        ps = c.page_size
        kvh, d = self.cache.k.shape[3], self.cache.k.shape[4]
        if int(meta["pageSize"]) != ps:
            raise ValueError(f"page-size mismatch: wire {meta['pageSize']} vs pool {ps}")
        if (int(meta["numLayers"]) != mc.num_layers or int(meta["kvHeads"]) != kvh
                or int(meta["headDim"]) != d):
            raise ValueError(
                f"pool geometry mismatch: wire L{meta['numLayers']}/H{meta['kvHeads']}/"
                f"D{meta['headDim']} vs L{mc.num_layers}/H{kvh}/D{d}")
        # the wire's dtype is the compute dtype on fp and int8 pools alike
        if str(meta["dtype"]) != c.dtype:
            raise ValueError(f"dtype mismatch: wire {meta['dtype']} vs pool {c.dtype}")
        n = min(int(k.shape[1]), len(token_ids) // ps)
        alloc = self.alloc
        keys = alloc.chain_keys(token_ids, n_pages=n)
        # claimed pages come back pinned and unregistered: a chain key
        # becomes matchable only after its page's data is written
        writes: list[tuple[int, int, bytes]] = []   # (page, wire index, key)
        installed = 0
        with self._alloc_lock:
            for i, key in enumerate(keys):
                if alloc.peek_key(key) is not None:
                    # the same content is cached here already (maybe pinned
                    # by a live request): keep it, skip the write
                    installed = i + 1
                    continue
                page = alloc.claim_page()
                if page is None:
                    break   # pool exhausted: keep the shorter prefix
                writes.append((page, i, key))
                installed = i + 1
        if writes:
            try:
                self._write_imported_pages([(p, i) for p, i, _ in writes], k, v, c.dtype)
                with self._alloc_lock:
                    for page, _i, key in writes:
                        alloc.register_claimed(page, key)
            finally:
                with self._alloc_lock:
                    alloc.unpin_pages([p for p, _, _ in writes])
        self._update_kv_gauges()
        return installed * ps

    def _write_imported_pages(self, writes: list[tuple[int, int]], k: np.ndarray,
                              v: np.ndarray, dtype: str,
                              k_rowscale: np.ndarray | None = None,
                              v_rowscale: np.ndarray | None = None) -> None:
        """Write host pages into pool pages with indexed assignment (the
        JAX engine's `.at[:, idx].set`): `writes` pairs a pool page with
        the index of its source page along k/v's page axis. `dtype` names
        k/v's wire dtype ("int8" with per-row scales [L, n, ps] for an int8
        record). On an int8 pool fp pages requantize per row on the host
        (the JAX package's numpy arithmetic, so both pools hold the same
        bytes); on an fp pool int8 rows dequantize and cast to the pool's
        dtype.

        On the card the copy to the device completes before this returns
        (a synchronous copy) and the assignment is launched on the current
        stream, the runner's default stream: a step launched after the
        caller registers the pages reads them written."""
        pages = [p for p, _ in writes]
        src = [i for _, i in writes]
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        k, v = k[:, src], v[:, src]
        if self._kv_int8:
            if k_rowscale is None:
                k, k_rowscale = quantize_rows_np(k, dtype)
                v, v_rowscale = quantize_rows_np(v, dtype)
            else:
                k_rowscale, v_rowscale = k_rowscale[:, src], v_rowscale[:, src]
            for pool, q, sc in ((self.cache.k, k, k_rowscale), (self.cache.v, v, v_rowscale)):
                pool.data[:, idx] = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
                pool.scale[:, idx] = torch.from_numpy(
                    np.ascontiguousarray(sc, np.float32)).to(self.device)
            return
        if k_rowscale is not None:
            k = np.asarray(k, np.float32) * k_rowscale[:, src][..., None, None]
            v = np.asarray(v, np.float32) * v_rowscale[:, src][..., None, None]
            dtype = "float32"
        self.cache.k[:, idx] = self._device_pages(k, dtype)
        self.cache.v[:, idx] = self._device_pages(v, dtype)

    def _spill_page_to_host(self, page: int, key: bytes) -> None:
        """Allocator spill hook: copy one about-to-be-evicted prefix-cache
        page into the host tier (under _alloc_lock, from inside the
        allocator's eviction). One synchronous device-to-host copy per
        page not yet in the tier. Best-effort: a failure (or the
        `kvtier.spill` fault site) loses the page from the tier, and the
        later match degrades to a cold prefill."""
        tier = self.host_tier
        if tier is None or self.plan_sink is not None or key in tier:
            return   # content-addressed: an existing host copy is valid
        if faults.check("kvtier.spill"):
            return
        idx = torch.tensor([page], dtype=torch.long, device=self.device)
        k_pool, v_pool = self.cache.k, self.cache.v
        if self._kv_int8:
            tier.put(key, k_pool.data[:, idx].cpu().numpy(), v_pool.data[:, idx].cpu().numpy(),
                     k_scale=k_pool.scale[:, idx].cpu().numpy(),
                     v_scale=v_pool.scale[:, idx].cpu().numpy(), quant="int8-rows")
        else:
            tier.put(key, self._host_words(k_pool[:, idx]), self._host_words(v_pool[:, idx]),
                     dtype=self.config.dtype)

    def _restore_page_from_host(self, key: bytes) -> int | None:
        """Allocator restore hook (match_prefix, under _alloc_lock, on a
        chain miss): page one spilled page back into a fresh pool page,
        register it under its chain key at refcount 0 and return its id so
        the match walks on. None on a tier miss, an injected fault, pool
        pressure or an integrity failure: the admission degrades to a cold
        prefill."""
        tier = self.host_tier
        if tier is None or self.plan_sink is not None:
            return None   # a restore writes the pool: the followers' would not
        rec = tier.get(key)
        if rec is None:
            return None
        if faults.check("kvtier.restore"):
            tier.note_restore_failure()
            return None
        alloc = self.alloc
        with self._alloc_lock:
            page = alloc.claim_page()
        if page is None:
            tier.note_restore_failure()   # pool pressure: nowhere to land
            return None
        try:
            self._install_restored_page(page, *rec)
        except Exception as e:  # noqa: BLE001 — degrade to a cold prefill
            log.warning("host-tier restore install failed for %s: %s", self.cfg.name, e)
            tier.note_restore_failure()
            with self._alloc_lock:
                alloc.unpin_pages([page])
            return None
        with self._alloc_lock:
            alloc.register_claimed(page, key)
            alloc.unpin_pages([page])
            out = alloc.peek_key(key)
        tier.mark_restored(key)
        return out

    def _install_restored_page(self, page: int, k: np.ndarray, v: np.ndarray,
                               ks: np.ndarray | None, vs: np.ndarray | None,
                               quant: str | None) -> None:
        """Decode one spill record to the pool's dtype and layout and write
        it into `page`. A raw record holds this pool's dtype."""
        if quant == "int8-rows":
            # rows and per-row scales [L, 1, ps]: verbatim on an int8 pool,
            # dequantized on an fp one
            self._write_imported_pages([(page, 0)], k, v, "int8",
                                       k_rowscale=np.asarray(ks, np.float32),
                                       v_rowscale=np.asarray(vs, np.float32))
        elif quant == "int8-page":
            self._write_imported_pages([(page, 0)], dequantize_page(k, ks),
                                       dequantize_page(v, vs), "float32")
        else:
            self._write_imported_pages([(page, 0)], k, v, self.config.dtype)

    def park_to_host(self, token_ids: list[int]) -> int:
        """Suspend to host: move the cached full-page prefix of `token_ids`
        into the host tier and FREE its device pages, so a suspended decode
        stops holding device memory. The resume's admission restores the
        pages through the match_prefix warm path. Pages still shared with a
        live request are copied but not freed. Returns the tokens whose
        pages now live in the host tier (contiguous from position 0)."""
        tier = self.host_tier
        if tier is None or self.plan_sink is not None or len(token_ids) < 2:
            return 0
        alloc = self.alloc
        with self._alloc_lock:
            pages, _covered = alloc.pin_prefix(token_ids)
        if not pages:
            return 0
        keys = alloc.chain_keys(token_ids, n_pages=len(pages))
        parked = 0
        try:
            for pg, key in zip(pages, keys):
                self._spill_page_to_host(pg, key)
                if key not in tier:
                    break   # keep the parked prefix contiguous
                parked += 1
        finally:
            with self._alloc_lock:
                alloc.unpin_pages(pages)
                alloc.evict_cached([pg for pg, key in zip(pages, keys) if key in tier])
        self._update_kv_gauges()
        return parked * self.config.page_size

    def memory_arrays(self) -> dict[str, Any]:
        """Device buffers and page-pool accounting for a memory probe: the
        weight and KV-pool tensors by identity, plus JSON-safe allocator
        numbers (the JAX engine's `memory_arrays`). Reads mutable state
        without locks, as batch_state() does."""
        if self.embedding_only:
            return {"weights": list(self.model.parameters()) if self.model is not None else [],
                    "kv": [], "alloc": None}
        cache, c = self.cache, self.config
        kv: list[torch.Tensor] = []
        for pool in (cache.k, cache.v):
            kv += [pool.data, pool.scale] if isinstance(pool, QuantPages) else [pool]
        kv_bytes = cache.k.nbytes + cache.v.nbytes
        bpp = kv_bytes / max(c.num_pages, 1)
        alloc = self.alloc
        used = c.num_pages - alloc.free_pages - alloc.cached_pages
        live_tokens = sum(len(st.ids) for st in list(self._slots.values()))
        capacity_tokens = used * c.page_size
        return {
            "weights": list(self.model.parameters()) if self.model is not None else [],
            "kv": kv + [cache.page_table, cache.lengths],
            "alloc": {
                "numPages": c.num_pages,
                "pageSize": c.page_size,
                "pagesUsed": used,
                "pagesCached": alloc.cached_pages,
                "pagesFree": alloc.free_pages,
                "bytesPerPage": int(bpp),
                "usedBytes": int(used * bpp),
                "cachedBytes": int(alloc.cached_pages * bpp),
                "freeBytes": int(alloc.free_pages * bpp),
                # the port's pools are never lane-padded
                "lanePadOverheadBytes": 0,
                "kvLayout": self._kv_layout(),
                "liveTokens": live_tokens,
                # capacity reserved at admission not yet holding tokens; a
                # shared prefix page counts once in pagesUsed but for every
                # sharer in liveTokens, hence the clamp at 0
                "fragmentation": (max(0.0, round(1 - live_tokens / capacity_tokens, 4))
                                  if capacity_tokens else 0.0),
                "kvInt8": self._kv_int8,
                "hostTier": self.host_tier.stats() if self.host_tier is not None else None,
            },
        }

    def batch_state(self) -> dict[str, Any]:
        """Point-in-time batch snapshot (read without locks: a torn read is
        cosmetic, a blocked diagnosis is not)."""
        now_ns = time.perf_counter_ns()
        wall = time.time()
        if self.embedding_only:
            return {"model": self.cfg.name, "device": str(self.device), "running": False,
                    "embeddingOnly": True, "slots": {}, "pending": 0, "inflightBlocks": 0,
                    "dispatchGen": 0, "freeSlots": 0, "kvPagesFree": None,
                    "kvPagesCached": None, "prefixCache": None, "hostTier": None,
                    "specDecode": None}
        slots = {
            str(slot): {
                "request": st.req.id,
                "phase": "decode" if st.t_first_decode else "prefill",
                "promptTokens": st.prompt_len,
                "generated": len(st.generated),
                "ageS": round((now_ns - st.t_start) / 1e9, 3),
                "sinceLastTokenS": (round(wall - st.t_last_ingest, 3)
                                    if st.t_last_ingest else None),
            }
            for slot, st in list(self._slots.items())
        }
        return {
            "model": self.cfg.name,
            "device": str(self.device),
            "running": self.running,
            "embeddingOnly": False,
            "slots": slots,
            "pending": len(self._pending),
            "inflightBlocks": len(self._inflight),
            "dispatchGen": self._gen,
            "freeSlots": len(self._free_slots),
            "kvPagesFree": self.alloc.free_pages,
            "kvPagesCached": self.alloc.cached_pages,
            "prefixCache": {"hits": self.alloc.hits, "misses": self.alloc.misses,
                            "evictions": self.alloc.evictions,
                            "cowCopies": self.alloc.cow_copies},
            "hostTier": self.host_tier.stats() if self.host_tier is not None else None,
            "specDecode": ({"k": self._spec_k, "drafter": self._drafter.kind,
                            "treeWidth": (self._tree_width
                                          if isinstance(self._drafter, DraftModelDrafter)
                                          else 1),
                            **self.spec_stats} if self._spec_k else None),
        }
