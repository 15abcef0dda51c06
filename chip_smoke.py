#!/usr/bin/env python3
"""Smoke run of gridllm_torch on one NVIDIA GPU (H100).

Phases, each printing one JSON line; any failure exits non-zero:
1. build   — compile the CUDA kernels of gridllm_torch/csrc/ with nvcc, one
             process per source, all at once.
2. kernels — hold each kernel against its plain PyTorch version on the
             card at llama3:8b widths, bf16 (tolerance 3e-2) and float32
             (1e-3); the KV writes (also a verify step's flattened rows)
             must match exactly on the valid region; causal groups wider
             than 32 tokens (Td = 64 at D = 64, the draft model's
             catch-up chunk, and Td = 33 at D = 128) on fp and int8
             pools, held to the row-relative error; both prefill wrappers
             (one kernel, csrc/flash_prefill.cu) at the edges of its tile
             plan (PREFILL_CASES: head groupings G = 1 (llava:7b), 2, 7
             and 8, D = 64, T not a multiple of the 128-key tile, seq_len
             inside a tile and at its edge, a window across tiles with
             softcap, B = 32 with a length per row and rows of length 1
             (an embedding batch)), q
             scaled by 4 and held to the row-relative error; the
             per-phase routes (csrc/per_phase_attention.cu): paged_decode
             in both modes (_decode_cases), prefix_chunk's chunk
             (_chunk_cases: the tensor-core route in bf16, the CUDA-core
             route in float32, each held to its leg counter) and the
             verify over slots (_verify_cases: S = 8 x T = 5, lengths 0
             to the capacity, window with softcap), then their long cases
             (_per_phase_long_cases: 0 to 25,600 cached tokens, a chunk
             after 16,384; q x 4, row-relative error within LONG_REL_TOL
             in bf16);
             ragged_attention at the edges of its chunk kernel's tile
             plan and of its group split (_ragged_cases: chunk starts
             of 48, 64 and 192, G = 7 at D = 64 and 128, G = 1 at KVH = 32
             (llava:7b: chunks at 0 and after 1,024, groups at Td = 1 and
             5 on a 64-page table), page size 16,
             a chunk after 16,384 cached tokens beside eight groups, one
             slot at 24,000, on shuffled tables with -1 entries).
3. timing  — each kernel at the main path's shapes (CUDA events, warm-up):
             kernel, plain version, one PyTorch library call where one
             exists, and the bound max(bytes / 3.35 TB/s, flops / 989
             TFLOP/s) computed from this run's inputs; the per-phase
             routes (_per_phase_timing: paged_decode at 8 x 1,024 and
             1 x 24,000, the verify attention of one layer at 8 x 5 after
             1,024, prefix_chunk's chunk after 1,024 and 16,384, each as
             events and device time, the first call of each under
             torch.cuda.set_sync_debug_mode("error"));
             ragged_attention's chunk region after 1,024 and 16,384
             cached tokens and its decode group at 8 x 1,024 and
             1 x 24,000, each also as profiler device time and beside SDPA
             on K/V gathered beforehand (a yardstick without paging), the
             decode group's first call under
             torch.cuda.set_sync_debug_mode("error"); paged_write_decode
             and index_put_ in three turns, and paged_write_decode's
             launch floor: its device time at 32 layers x 8 rows and at
             1 layer x 1 row, in two turns.
4. model   — llama3:8b cut to 2 layers, full width, float32, against the
             cache-free forward to 1e-3, in both attention modes: ragged
             (bucket prefill, decode steps, mixed steps admitting a second
             slot, verify steps of K+1 = 5) and per-phase (decode steps
             through paged_decode, a prefill_chunk admission and verify
             steps through prefix_chunk).
5. serve   — llama3:8b (bf16, random weights from seed 0) behind the
             engine's runner thread in four settings, one engine after
             the other: the default (speculative decoding on, ragged
             attention on) with eight concurrent requests, a prefix-cache
             repeat and greedy determinism checks, and a solo prompt's
             last-token logits from its cold bucket prefill held to the
             cache-free forward with the plain attention and to its warm
             chunk-region admission (row-relative error,
             SERVE_WARM_COLD_REL); the same eight requests
             with spec off (tokens/s of both); then spec on and spec off
             with the per-phase kernels, a prompt longer than one chunk and
             a prefix-cache repeat each. Finite logits of the expected
             shapes from every model call. Each setting's launch counters
             are set to 0 just before it serves and read just after: every
             kernel of its path launched, none of another path did, and a
             verify step launched its attention once per layer, all slots
             in one launch (ragged_attention, or per-phase exactly
             layers x verify steps prefix_chunk.slots launches). The
             kernels line reports each kernel's launches from the setting
             that carries it.
6. worker  — llama3:8b bf16 with the engine's defaults behind the port's
             WorkerService on the port's InMemoryBus, a stand-in for the
             scheduler on the other side (assignments on
             worker_job_channel, frames on job_stream_channel, results on
             job_result_channel and job:failed, snapshots on
             job:snapshot): eight concurrent generate and chat streams
             (one prompt longer than a chunk), a ninth assignment NACKed,
             one stream cancelled (done_reason "cancel", no result),
             prefix-cache repeats; every stream put together equal to its
             final text; TTFT p50 and output tokens/s as the stand-in sees
             them; launch counters from 0 over the main path:
             flash_prefill, ragged_attention and both KV writes launched,
             no plain version on the card. Then a worker killed
             mid-decode (its bus silenced, its generation dropped) and its
             job resumed from the last snapshot on a second WorkerService:
             in bf16 a reading, in float32 byte-identical to the
             undisturbed run with the same eval_count. The output columns
             of ids the byte tokenizer does not print as ASCII are zeroed
             (_printable_head), so streams carry text. Then a fresh
             engine that prewarms at construction
             (GRIDLLM_PREWARM_COMPILES=1) serves the seven streams with no
             warm-up job: TTFT p50 and tokens/s, a reading.
7. sched   — the port's scheduler (phase_sched): WorkerRegistry and
             JobScheduler on the port's InMemoryBus over two port
             WorkerServices, each llama3:8b bf16 with the engine's defaults
             and SCHED_SLOTS slots; 16 concurrent generate and chat jobs
             through submit_streaming_job and submit_and_wait (one prompt
             longer than a chunk; the four past the 12 advertised slots
             wait in the scheduler's queue), spread over both workers,
             one cancelled mid-stream through cancel_job, two
             prefix-affinity repeats landing on the worker whose
             heartbeat digest holds their prefix, a drain mid-decode the
             scheduler hands off; launch counters from 0 over that path,
             no plain version on the card, the usage ledger's two halves
             equal, both workers healthy; then a worker killed mid-decode
             on the 8-layer float32 cut, evicted by the registry, its job
             requeued with its watermark and finished on the survivor
             byte-identical to the undisturbed run. Reads from the
             scheduler's own trace TTFT p50/p90 (submit to the first
             chunk), the queue wait (its queue spans) and its host time
             (submit to the assignment's publish); output tokens/s.
8. replay  — the warm prefix-cache replay held to the cold run: llama3:8b
             in float32 serves a prompt cold, then again from the prefix
             cache, and the greedy streams must be identical; then, in
             bf16, each operation of a replayed prompt row and of a decode
             row computed both ways (ragged chunk region vs flash_prefill,
             group region alone vs beside a chunk, norms and projections
             in 8-, 1024- and 1032-row products), to show where bf16
             rounding departs between batch contexts.
9. spec    — llama3:8b in float32: a repetitive prompt whose drafts get
             accepted gives the same greedy stream with speculative
             decoding on and off, with ragged attention on and off.
10. checkpoint — llama3.2:1b at full width (bf16, tied embeddings): its
             random weights written with save_checkpoint into a temporary
             directory (removed after), loaded back through
             checkpoint_path (every parameter equal bit for bit; load
             seconds, GB/s and peak host memory growth), four greedy
             prompts (one past the 1,024-token chunk) served from the file
             with the random-init engine's streams, the four main-path
             kernels launched and no plain version on the card; the same
             directory by an unregistered name (config.json); the weights
             parked in the snapshot tier (device memory falls by at least
             their bytes) and restored from it (load_source "snapshot",
             equal streams); two cold child processes loading with
             GRIDLLM_PREWARM_COMPILES off and on (a reading: the first
             request's time to its first token); the port's Prometheus
             text: every engine, prefix-cache, device-memory and
             weight-snapshot series defined, no dispatch on the plain
             path, the memory limit the card's; the sampler's threefry
             bits on CUDA equal to the CPU's over 64 seeds x 64 steps,
             its Gumbel draws within 2 ulp.
11. int8    — the resident int8 KV pool (kv_int8): ragged_attention's
             int8 leg against its plain version (the pool dequantized
             through gather_kv) in bf16 and float32 compute, q scaled by 4
             and held to the row-relative error, per-row scales spanning
             two decades: decode groups S = 8 at 1024 cached, a Td = 5
             group, a 1024-row chunk after 1024, a mixed launch, window
             4096 with softcap 30, D = 64, a chunk past its table's
             capacity, a chunk after 16,384 and groups at 24000-32763
             cached on a 512-entry table; each call held to its leg
             counters (a bf16 chunk on the tensor cores, `.chunk`, a
             float32 one on the CUDA cores, every launch `.int8`); a
             chunk whose staged table row passes the card's shared
             memory refused with a clear error before any launch; timed
             in turns with the fp leg at its shapes (decode, the chunk
             after 1,024 and 16,384 beside SDPA on dequantized K/V, the
             verify width); a 2-layer float32 llama3:8b cut with an int8
             pool through the kernels against the same steps through the
             plain versions; then llama3:8b bf16 with kv_int8=True serving
             the serve phase's eight requests and a warm prefix-cache
             repeat: every ragged launch through the int8 leg, one chunk
             launch per layer of each chunked admission and mixed step and
             none on the CUDA cores, flash_prefill, and no write kernel
             (int8 writes are indexed assignments) nor per-phase kernel;
             pool bytes per page 0.502x bf16's.
12. profiler — PROFILER_RUNS child processes, each llama3:8b bf16 with
             the engine's defaults and its runner thread live serving
             eight concurrent requests inside an InferenceEngine.profile()
             capture (torch.profiler, CPU and CUDA activity), then eight
             more across PROFILER_MID_FLIGHT captures opened and closed
             mid-decode, then a capture the engine did not start, which
             must be refused; faulthandler on. Fails if a child dies by a
             signal or fails a check.
13. long   — long-context serving, llama3.1:8b: flash_prefill_streamed
             against its blocked plain version (bf16 at T = 32768 with
             seq_len 24001 and 32768, float32 at T = 16384, D = 64,
             window and softcap, G = 7 at T = 20000), the ported kernels
             at long positions (ragged decode and a 1024-row chunk after a
             24k prefix on a 512-entry table, paged_write_chunk of 32768
             rows into a pool
             of more than 2^31 elements); attention with q scaled by 4 and
             held to the row-relative error (LONG_Q_SCALE). Timed beside
             flash_prefill and SDPA on full buckets of 1024 to 32768
             tokens; a 2-layer float32 cut against its cache-free forward
             (a 10000-token prompt in the 16384 bucket, then ragged decode
             steps; the forward's attention is the blocked plain version);
             then the engine in bf16
             serving a 24001-token prompt whole in the 32768 bucket beside
             a short request (32 flash_prefill_streamed launches), and its
             warm repeat as one 32768-row mixed-step chunk.
14. tree   — draft-model tree speculation: ragged_attention's tree leg
             against its plain version (ragged_paged_attention_ref with
             tree_pos/tree_mask), q scaled by 4 and held to the
             row-relative error, in bf16 and float32 compute, fp and int8
             pools, D = 128 and 64, trees (4, 2) (the default), (4, 1) (a
             chain, also held to the causal group), (4, 8) and (16, 16)
             (32 nodes, bit 31 set), a window of 4096 with softcap 30,
             slots from 0 to 32,700 cached tokens on a 512-entry table;
             timed at S = 8, N = 6 after 1,024 cached tokens beside the
             causal group at Td = 5 and 6, and the draft's Td = 64 group
             at D = 64; a 2-layer float32 llama3:8b cut on an fp and an
             int8 pool checking a sibling-rescued tree step and its row
             compaction (spec_accept_tree, commit_tree_path) against the
             same tokens one at a time; llama3:8b bf16 with
             draft_model="llama3.2:1b", the draft read from a checkpoint
             of its random weights (draft_checkpoint), serving the serve
             phase's eight requests and a warm repeat, held to 32 tree
             launches per verify step, draft launches, and no per-phase
             kernel, and one more request's stream held to an engine's
             whose draft weights were made in memory; then
             float32 llama3.2:1b self-drafted greedy streams held to spec
             off with ragged attention on, off, and with kv_int8.
15. kvx    — KV movement and the host KV tier (phase_kvx): two port
             WorkerServices on the port's InMemoryBus, a stand-in
             scheduler that makes the handoffs; llama3:8b bf16 with the
             engine's defaults serves a 1,500-byte prompt disaggregated
             (export_only prefill, export, transfer over bus chunks and
             over HTTP to the decode worker's /kvx/ route, import,
             decode), imported pages equal to the exporter's bit for bit,
             first-token logits within SERVE_WARM_COLD_REL of unified
             serving; a graceful drain mid-decode moving the pages to the
             peer, exactly once; an int8-pool engine's pages into a bf16
             engine and back; the same disaggregated job and drain on an
             8-layer float32 cut, streams byte-identical to unified and
             undisturbed serving; the host tier on a 48-page pool (spill
             and restore ms per page, restored repeat equal to the
             device-warm one, park frees its pages, float32 streams equal
             with the tier on and off). Reads export, import, bus and HTTP
             GB/s and TTFT after an import beside unified TTFT.
16. gemma  — gemma2 and head dim 256 (phase_gemma): every kernel at D = 256
             and gemma2:9b's widths (H 16, KVH 8, pages of 64, 128-entry
             tables) against its plain version, q scaled by 4 and held to
             the row-relative error and to its launch counters
             (_gemma_kernel_cases: flash_prefill at T 1,024, 4,096 and a
             window of 4,096 with softcap 50 at 8,192, float32 at 1,000;
             flash_prefill_streamed at 16,384; ragged groups at Td 1 and 5
             with and without the window, chunks of 1,024 after 1,024 and
             after 5,000 with the window, a mixed launch, the int8 and
             tree legs, in bf16 and float32; paged_decode in both modes,
             prefix_chunk's routes; both writes exact); each timed beside
             its bound and SDPA for the prefill kernels (_gemma_timing); a
             2-layer full-width float32 cut with random norms against its
             cache-free forward in both attention modes on a 5,000-token
             prompt (layer 0's window drops keys; only the last rows'
             logits made); gemma2:9b bf16 with the engine's defaults
             serving the serve phase's eight requests plus a 6,000-byte
             prompt in chunks of 1,024 and its warm repeat, launch
             counters from 0 held to the ragged path, every ragged launch
             at D = 256 (tokens/s, TTFT); float32 spec-on streams equal to
             spec-off on the cut, ragged attention on and off.
17. quant  — int8 weights (phase_quant): one llama3:70b layer slice
             ([8192, 28672]) quantized on the card bit-equal to the CPU
             (quantize_array and the blocked quantize_into); qdot at a
             decode shape (8 x 8,192 -> 28,672) timed beside the bf16
             torch.matmul and the bounds of the int8 read and of the plain
             form's traffic; a 2-layer full-width float32 cut of
             llama3:70b with int8 weights, its paged path (bucket prefill,
             decode, mixed and verify steps) against its cache-free
             forward to 1e-3 and its logits within 0.15 (relative to their
             largest) of the unquantized model's from the same generator;
             then llama3:70b with quantize="int8", all 80 layers at full
             width, bf16 activations, the engine's defaults and the pool
             sized to the memory the weights leave, serving the serve
             phase's eight requests plus a 2,000-byte prompt in chunks:
             weight bytes equal to params_nbytes' count from shapes,
             tokens/s, TTFT, peak memory, launch counters from 0 held to
             the ragged path.
18. mixtral — the mixtral family (phase_mixtral): the dense and ragged MoE
             forms of one full-width float32 layer against each other
             (1e-4 relative) at 8, 40 and 1,024 tokens and timed in bf16
             at 8 and 1,024 beside the expert bytes each reads; a 2-layer
             full-width float32 cut against its cache-free forward to 1e-3
             (decode in the dense form, the calls of 16 or more tokens in
             the ragged form); mixtral:8x7b bf16 at full width cut to 16
             of its 32 layers (43.7 GiB; 87.0 GiB at full depth) serving
             the eight requests and the 2,000-byte prompt: tokens/s, TTFT,
             MoE calls by form, launch counters from 0 held to the ragged
             path.
19. gateway — HTTP through the port's gateway (phase_gateway):
             GatewayServer in local control-plane mode on the port's
             InMemoryBus at 127.0.0.1:0, in front of the port's scheduler
             and one WorkerService on llama3:8b bf16 (all 32 layers, the
             engine's defaults); every surface once (Ollama, OpenAI over
             SSE, /inference with a DELETE mid-generation, health, tags,
             models, /metrics, /admin/trace, a 404 and a 400), then eight
             streamed generations three ways in turns: (a) a bus client
             straight to a worker, (b) the scheduler's
             submit_streaming_job, (c) HTTP (TTFT p50/p90, tokens/s per
             way, on a line of their own); launch counters from 0 held to
             the ragged path; the 8-layer float32 cut's greedy text through
             HTTP equal to the scheduler's.
20. controlplane — the scaled control plane through the port's own entry
             points (phase_controlplane), each a process: two brokers
             (python -m gridllm_torch.bus.broker --aof), two scheduler
             shards (python -m gridllm_torch.controlplane, 2,000 ms leases
             renewed every 400 ms) and two gateway replicas
             (GRIDLLM_CONTROLPLANE=gateway python -m gridllm_torch.gateway)
             on the first; in this process the port's WorkerService on
             llama3:8b bf16 (all 32 layers, the engine's defaults) on that
             broker and a local-mode GatewayServer with a worker of its own
             on the same engine on the second broker. Every fleet surface
             once (/health/workers, /admin/slo, /admin/capacity,
             /admin/dump?fleet=1, gridllm_shard_lease_held, /api/generate
             through each replica), eight concurrent streams two ways in
             turns, (d) the local gateway and (e) the fleet (TTFT p50/p90,
             tokens/s per way, on a line of their own with the adoption's
             seconds); launch counters from 0 held to the ragged path; on
             the 8-layer float32 cut the owning shard SIGKILLed after the
             5th frame of a stream: byte-identical to the undisturbed
             stream, the survivor at epoch 2, one assignment, nothing
             orphaned, a second request on the adopted partition served.
21. embed  — embeddings through the port's gateway (phase_embed): one
             WorkerService serving mxbai-embed-large (bf16, 24 layers, cls
             pooling, an embedding-only engine) and llama3:8b (bf16, 32
             layers, mean pooling over flash_prefill at B up to 32, a
             length per row); /api/embed batches of 32 texts of 0-511
             bytes (ms per batch, texts/s), unit norms, each of eight
             texts alone within EMBED_BF16_L2 of its batched vector,
             launches from 0 (flash_prefill alone for llama3:8b, none for
             the encoder, whose attention is plain torch as in the JAX
             package), no plain version; float32 cuts at 2 layers: llama3:8b
             through the kernel against the plain attention, mxbai batched
             against alone.
22. vision — llava:7b bf16 through the port's gateway (phase_vision): the
             32-layer multi-head stack (G = 1) and the CLIP-L/336 tower;
             PNGs this script writes (zlib and struct, every row filter)
             of seeded 640 x 480 pictures, decoded by the port's own
             decoder (checked against the pixels); solo one-image,
             same-length text and two-image requests (TTFT p50 each), two
             waves of eight concurrent generate and chat streams with one
             and two images (TTFT p50, tokens/s), launches from 0 of every
             kernel of the ragged path, no plain version; the host's
             preprocessing ms per picture and encode_images' ms and
             device ms for one and two images; a 2-layer float32 cut whose
             greedy streams with one image (bucket) and two (chunks with
             splice offsets) equal the cache-free forward over the spliced
             embeddings with the plain attention.
23. tp     — tensor parallelism (phase_tp): an NCCL group of world size 1
             initializes and all-reduces a CUDA tensor (one card holds
             no two ranks of an NCCL group); two ranks on gloo, both on
             cuda:0 (child processes), report which collectives gloo runs
             on CUDA tensors and serve a float32 cut of llama3:8b (2
             layers, full width, tp = 2: H 16 and KVH 4 a rank) whose
             greedy streams, a bucket prefill and a chunked prompt with
             speculation on, equal the unmeshed engine's in this process;
             then llama3:8b bf16 at full width and depth served through the
             port's broker and scheduler by a two-rank group of
             worker/main.py processes (the liaison registers one logical
             worker, the follower replays its plan), then by one unmeshed
             worker process, each a warm-up and an eight-job wave (one
             prompt past the chunk): TTFT p50 and output tokens/s (gloo
             puts a host round trip in every all-reduce: a correctness
             run), each member's launch counters from 0 over the wave
             (every main-path kernel on both ranks, the same counts on
             each) and its all-reduces. Then the float32 cut modes
             (TP_CUT_MODES, 2 layers, full width), each served as a worker
             group serves: rank 0 with its plan records going through the
             group's TCP store, rank 1 replaying them; rank 0's streams
             equal the unmeshed engine's, rank 1 holds the same replicated
             state: gemma2:9b, llava:7b with a picture, llama3:8b with int8
             weights, with ragged attention off (speculation off and on),
             with llama3.2:1b's trees (the draft model on rank 0 alone, cut
             to 2 layers) and with a warm prefix hit (cached > 0 on both
             ranks); mxbai-embed-large's float32 embeddings on both ranks
             within 1e-5 of the unmeshed engine's. Then bf16 serves of
             TP_SERVES through the bus worker, each a two-rank group and an
             unmeshed worker with the same models and jobs: llama3:8b with
             llama3.2:1b's trees beside mxbai-embed-large's embedding job;
             gemma2:9b, llama3:8b with int8 weights and llava:7b with a
             picture. The kernels phase holds every main-path kernel and
             the streamed prefill at the per-rank shapes of tp = 2 and 4
             (TP_DEGREES), and at tp = 2 gemma2:9b's (H 8, KVH 4, D 256,
             its window and softcap on the ragged legs) and llava:7b's
             (G = 1), the per-phase routes and the tree leg at
             llama3:8b's (H 16, KVH 4).
24. ep     — expert parallelism and dp replicas (phase_ep): four ranks
             of one gloo world, all on cuda:0 (child processes), build
             the meshes in turn and serve float32 2-layer full-width cuts
             (EP_CUTS, speculation off so decode steps take the dense MoE
             form) as a worker group does, rank 0 serving, the others
             replaying its plan: mixtral:8x7b under ep 2 x tp 2 (X/2
             experts on F/2 a rank, H 16 and KVH 4) and dp 2 x ep 2 (two
             ep = 2 pairs, attention whole), llama3:8b under dp 2 x tp 2;
             rank 0's streams equal the unmeshed engine's in this
             process, every follower holds the same replicated state,
             every mixtral rank takes both meshed MoE forms with one
             all-reduce per meshed MoE call. Then mixtral:8x7b bf16 at
             MIXTRAL_LAYERS layers served through the port's broker and
             scheduler by an ep = 2 group of worker/main.py processes,
             then (both at once exceed the card) by one unmeshed worker:
             TTFT p50, tokens/s, each member's peak allocated GiB,
             launches, collectives and MoE calls by form.
Then the kernels line (the seven kernels, ragged_attention's chunk
kernel, its int8 and tree legs, and prefix_chunk's slots and chunk
routes, each with the head dims compiled and its launches under the
scheduler, on the quant and mixtral serves, behind the gateway, behind
the scaled control plane, on the embeddings, on llava, on each rank of
the tp phase's group and of the ep phase's groups; then the same rows at D = 256 from the gemma phase,
named "<kernel>.d256"), the card's name and power limit, and the result.

Usage: python3 chip_smoke.py [--phases build,kernels,timing,model,serve,worker,sched,replay,spec,checkpoint,int8,profiler,long,tree,kvx,gemma,quant,mixtral,gateway,controlplane,embed,vision,tp,ep]
       python3 chip_smoke.py --turns OTHER_TREE [--turn-parts kernels,steps,int8]
(--turns: the per-phase timing rows, with `steps` the single-call profile
of tools/profile_step.py, with `int8` the int8 leg's timing rows and the
int8-pool engine's profile, of another checkout of the port and of this
one in turns on one card; no result line.)
Needs one CUDA device; exits non-zero without one. Writes the compiler's
register report to chiprun_out/ptxas.txt.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
SEED = 0
# llama3:8b attention widths and the engine's default pool geometry
H, KVH, D, PS, S, MAXP = 32, 8, 128, 64, 8, 128
ALL_PHASES = ("build", "kernels", "timing", "model", "serve", "worker", "sched", "replay",
              "spec", "checkpoint", "int8", "profiler", "long", "tree", "kvx", "gemma", "quant",
              "mixtral", "gateway", "controlplane", "embed", "vision", "tp", "ep")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call: the summed durations of the CUDA kernels
    that `iters` calls launched (torch.profiler), over iters. time_ms
    times back-to-back calls, so it reads the host's time instead when a
    wrapper takes longer on the host than its kernels on the card."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(e.device_time_total for e in prof.events() if e.device_type == cuda)
    return us / 1e3 / iters


def _no_host_sync(torch, fn) -> None:
    """Call fn under torch.cuda.set_sync_debug_mode("error"): a host sync
    in it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


class Inputs:
    """Seeded random tensors on the card."""

    def __init__(self, torch, seed: int):
        self.torch = torch
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(seed)

    def randn(self, *shape, dtype):
        t = self.torch.randn(shape, generator=self.gen, device="cuda", dtype=self.torch.float32)
        return t.to(dtype)

    def pools(self, n_layers, dtype):
        shape = (n_layers, S * MAXP, PS, KVH, D)
        return self.randn(*shape, dtype=dtype), self.randn(*shape, dtype=dtype)

    def page_table(self, lengths, extra: int = 0):
        """A random page permutation, one row per slot; entries past the
        pages a slot needs (lengths + extra tokens) are unmapped (-1)."""
        torch = self.torch
        perm = torch.randperm(S * MAXP, generator=self.gen, device="cuda").to(torch.int32)
        table = perm.reshape(S, MAXP).clone()
        for s, ln in enumerate(lengths):
            table[s, -(-(ln + extra) // PS):] = -1
        return table


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _chunk_sass_counts(lib: Path) -> dict:
    """`HGMMA` and `UTMALDG` instructions in each instantiation of
    ragged_chunk_kernel<D, kCap, kDev, kFresh, kQuant> (cuobjdump -sass of
    the built library), each of which must hold wgmma; {} without
    cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name = {}, None
    pat = re.compile(r"ragged_chunk_kernelILi(\d+)ELb([01])ELb([01])ELb([01])ELb([01])E")
    for line in sass.splitlines():
        if "Function :" in line:
            m = pat.search(line)
            name = None if m is None else "D{}_cap{}_dev{}_fresh{}_int8{}".format(*m.groups())
            if name:
                counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                counts[name][op] += op in line
    check(counts and all(c["HGMMA"] > 0 for c in counts.values()),
          f"build: a ragged_chunk_kernel instantiation without wgmma: {counts}")
    return counts


def phase_build() -> dict:
    from gridllm_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ptxas.txt").write_text(
        "\n".join(f"== {src}\n{r['ptxas']}" for src, r in report.items()))
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "sources": {src: round(r["seconds"], 2) for src, r in report.items()},
            "ragged_chunk_sass": _chunk_sass_counts(_build._lib_path("ragged_attention.cu"))}


def _ragged_cases(inp: Inputs, dtype):
    """(name, kwargs, chunk_valid_rows, relative) cases of ragged_attention:
    llama3:8b widths on a shuffled page table whose entries past each
    slot's pages are -1 (an empty slot, page straddles, window, softcap, a
    mixed launch), then the edges of the chunk kernel's tile plan and of
    the group split (relative: q scaled by LONG_Q_SCALE, held to the
    row-relative error): chunk starts of 64, 48 and 192 (page-aligned, not
    multiples of the 128-key tile), head groupings G = 7 at D = 64
    (qwen2.5:0.5b) and D = 128 (qwen2.5:7b) with window and softcap, page
    size 16 (eight boxes per tile), a chunk whose table ends inside it
    (rows past the capacity cut), a chunk after 16,384 cached tokens
    beside eight decode groups, and one slot at ~24k cached tokens."""
    torch = inp.torch
    lengths = [0, 1, 63, 64, 65, 700, 1500, 4000]   # straddles + an empty slot
    kp, vp = inp.pools(2, dtype)
    table = inp.page_table(lengths, extra=5)
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def group(td):
        return dict(q_group=inp.randn(S, td, H, D, dtype=dtype), page_table=table,
                    group_lengths=glens, k_group=inp.randn(S, td, KVH, D, dtype=dtype),
                    v_group=inp.randn(S, td, KVH, D, dtype=dtype))

    def chunk(c, start, valid):
        row = table[6]  # slot 6 owns 1500 + 5 tokens of pages
        return dict(q_chunk=inp.randn(1, c, H, D, dtype=dtype), chunk_row=row,
                    chunk_start=start, chunk_total=start + valid,
                    k_chunk=inp.randn(c, KVH, D, dtype=dtype),
                    v_chunk=inp.randn(c, KVH, D, dtype=dtype))

    base = dict(k_pages=kp, v_pages=vp, page_size=PS, layer=1)
    cases = [
        ("chunk_only", {**base, **chunk(256, 128, 200)}, 200, False),
        ("group_td1", {**base, **group(1)}, None, False),
        ("chunk_and_group", {**base, **chunk(1024, 448, 1000), **group(1)}, 1000, False),
        ("group_td5", {**base, **group(5)}, None, False),
        ("group_window", {**base, **group(1), "window": 100}, None, False),
        ("chunk_window_softcap", {**base, **chunk(256, 1216, 256), "window": 300,
                                  "softcap": 30.0}, 256, False),
        ("group_softcap", {**base, **group(5), "softcap": 30.0}, None, False),
    ]

    def q4(*shape):
        return inp.randn(*shape, dtype=dtype) * LONG_Q_SCALE

    def edge_chunk(name, h, kvh, d, ps, c, start, valid, n_pool, window=0, cap=0.0,
                   table_pages=None):
        """One chunk on a pool of its own: a shuffled table row, -1 past
        the chunk's pages; or a row of `table_pages` pages, all mapped,
        that ends inside the chunk (its rows past the capacity cut)."""
        n_table = table_pages or -(-(start + c) // ps) + 3
        row = torch.randperm(n_pool, generator=inp.gen, device="cuda")[:n_table].to(torch.int32)
        if table_pages is None:
            row[-(-(start + c) // ps):] = -1
        pool = (2, n_pool, ps, kvh, d)
        kw = dict(k_pages=inp.randn(*pool, dtype=dtype), v_pages=inp.randn(*pool, dtype=dtype),
                  page_size=ps, layer=1, q_chunk=q4(1, c, h, d), chunk_row=row,
                  chunk_start=start, chunk_total=start + valid,
                  k_chunk=inp.randn(c, kvh, d, dtype=dtype),
                  v_chunk=inp.randn(c, kvh, d, dtype=dtype), window=window, softcap=cap)
        return (name, kw, valid, True)

    cases += [
        # llava:7b's multi-head stack, G = 1 at KVH = 32: the first chunk of
        # a two-image prompt and the chunk after it
        edge_chunk("chunk_mha_g1_start0", 32, 32, D, PS, 1024, 0, 1024, 48),
        edge_chunk("chunk_mha_g1_after_1024", 32, 32, D, PS, 1024, 1024, 170, 48),
        edge_chunk("chunk_start64_g7_d64", 14, 2, 64, PS, 300, 64, 290, 64),
        edge_chunk("chunk_start192_g7_window_softcap", 28, 4, D, PS, 256, 192, 256, 64,
                   window=200, cap=30.0),
        edge_chunk("chunk_ps16_start48", H, KVH, D, 16, 200, 48, 180, 64),
        edge_chunk("chunk_past_capacity", H, KVH, D, PS, 128, 192, 128, 64, table_pages=4),
    ]
    # a chunk after 16,384 cached tokens beside eight decode groups, then
    # one slot at ~24k cached tokens (the group split over many spans)
    n_pool, maxp = 1024, 400
    kp, vp = (inp.randn(1, n_pool, PS, KVH, D, dtype=dtype) for _ in range(2))
    table = torch.randperm(n_pool, generator=inp.gen, device="cuda").to(torch.int32)
    table = table[:2 * maxp].reshape(2, maxp).contiguous()
    table[0, -(-(16384 + 1024) // PS):] = -1
    table[1, -(-24001 // PS):] = -1
    long = dict(k_pages=kp, v_pages=vp, page_size=PS, layer=0)
    glens = torch.tensor([16384 + 1024 - 1, 700, 0, 65, 5000, 12000, 16000, 9000],
                         dtype=torch.int32, device="cuda")
    cases += [
        ("chunk_after_16384_with_groups",
         {**long, "q_chunk": q4(1, 1024, H, D), "chunk_row": table[0], "chunk_start": 16384,
          "chunk_total": 16384 + 1000, "k_chunk": inp.randn(1024, KVH, D, dtype=dtype),
          "v_chunk": inp.randn(1024, KVH, D, dtype=dtype), "q_group": q4(S, 1, H, D),
          "page_table": table[0:1].expand(S, maxp).contiguous(), "group_lengths": glens,
          "k_group": inp.randn(S, 1, KVH, D, dtype=dtype),
          "v_group": inp.randn(S, 1, KVH, D, dtype=dtype)}, 1000, True),
        ("group_one_slot_24000",
         {**long, "q_group": q4(1, 1, H, D), "page_table": table[1:2],
          "group_lengths": torch.tensor([24000], dtype=torch.int32, device="cuda"),
          "k_group": inp.randn(1, 1, KVH, D, dtype=dtype),
          "v_group": inp.randn(1, 1, KVH, D, dtype=dtype)}, None, True),
    ]
    cases += [c for tp in TP_DEGREES for c in _tp_rank_ragged_cases(inp, dtype, tp)]
    for model, shape in TP_RANK_MODELS.items():
        cases += _tp_rank_ragged_cases(inp, dtype, 2, model, *shape)
    # G = 1 groups at KVH = 32 (llava:7b): decode and a verify of K+1 = 5
    # on a shuffled table of 64 pages a slot (llava's 4,096 tokens), an
    # empty slot and a slot at the capacity's edge
    mha, maxp = 32, 64
    n_pool = S * maxp
    kp, vp = (inp.randn(1, n_pool, PS, mha, D, dtype=dtype) for _ in range(2))
    lengths = [0, 1, 63, 583, 1200, 1729, 3000, 4090]
    table = torch.randperm(n_pool, generator=inp.gen, device="cuda").to(torch.int32)
    table = table.reshape(S, maxp).contiguous()
    for s, ln in enumerate(lengths):
        table[s, -(-(ln + 5) // PS):] = -1
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for td in (1, 5):
        cases.append((f"group_mha_g1_td{td}",
                      {"k_pages": kp, "v_pages": vp, "page_size": PS, "layer": 0,
                       "q_group": q4(S, td, mha, D), "page_table": table,
                       "group_lengths": glens,
                       "k_group": inp.randn(S, td, mha, D, dtype=dtype),
                       "v_group": inp.randn(S, td, mha, D, dtype=dtype)}, None, True))
    return cases


# a rank's attention under tp = 2 for the families a group serves beside
# llama3:8b: (H, KVH, D, window, softcap, slot lengths) of the whole model.
# gemma2:9b's ragged legs take its window and softcap, its slots reaching
# past the window; llava:7b's multi-head stack (G = 1)
TP_RANK_MODELS = {
    "gemma2_9b": (16, 8, 256, 4096, 50.0, [0, 1, 63, 700, 4095, 4097, 6000, 8000]),
    "llava_7b": (32, 32, 128, 0, 0.0, [0, 1, 63, 700, 1500, 2047, 3000, 4000]),
}


def _tp_rank_ragged_cases(inp: Inputs, dtype, tp: int, model: str = "llama3_8b",
                          n_heads: int = H, n_kv: int = KVH, d: int = D, window: int = 0,
                          softcap: float = 0.0, lengths=(0, 1, 63, 700, 1500, 2047, 3000, 4000)):
    """ragged_attention at a model's per-rank shapes under `tp` (H/tp q
    heads over KVH/tp kv heads, the rank's own pool; llama3:8b's by
    default, TP_RANK_MODELS'): a 1024-row chunk after 1024 cached tokens
    beside eight decode groups (a mixed step), and verify groups of K+1 =
    5, on a shuffled table with -1 past each slot's pages; q scaled by
    LONG_Q_SCALE, held to the row-relative error."""
    torch = inp.torch
    h, kvh = n_heads // tp, n_kv // tp
    lengths = list(lengths)
    n_pool = S * MAXP
    kp, vp = (inp.randn(2, n_pool, PS, kvh, d, dtype=dtype) for _ in range(2))
    table = inp.page_table(lengths, extra=5)
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    base = dict(k_pages=kp, v_pages=vp, page_size=PS, layer=1, page_table=table,
                group_lengths=glens, softcap=softcap, window=window)

    def group(td):
        return dict(q_group=inp.randn(S, td, h, d, dtype=dtype) * LONG_Q_SCALE,
                    k_group=inp.randn(S, td, kvh, d, dtype=dtype),
                    v_group=inp.randn(S, td, kvh, d, dtype=dtype))

    chunk = dict(q_chunk=inp.randn(1, 1024, h, d, dtype=dtype) * LONG_Q_SCALE,
                 chunk_row=table[5], chunk_start=1024, chunk_total=2048,
                 k_chunk=inp.randn(1024, kvh, d, dtype=dtype),
                 v_chunk=inp.randn(1024, kvh, d, dtype=dtype))
    tag = f"tp{tp}_rank" if model == "llama3_8b" else f"{model}_tp{tp}_rank"
    return [(f"{tag}_chunk_after_1024_with_groups", {**base, **chunk, **group(1)},
             1024, True),
            (f"{tag}_group_td5", {**base, **group(5)}, None, True)]


def _tp_rank_per_phase_cases(inp: Inputs, dtype, tp: int = 2):
    """(name, wrapper, kwargs, rows) of the per-phase routes at llama3:8b's
    per-rank heads under `tp` (H 16, KVH 4 at tp = 2), q scaled by
    LONG_Q_SCALE: paged_decode of eight slots after 1,024 cached tokens
    (the current token merged), a 1,024-row chunk after 1,024 with fresh
    K/V, and the 8 × 5 verify over slots after 1,024."""
    torch = inp.torch
    h, kvh = H // tp, KVH // tp
    kp, vp = (inp.randn(2, S * MAXP, PS, kvh, D, dtype=dtype) for _ in range(2))
    lengths = [1024] * S
    table = inp.page_table(lengths, extra=1024)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    base = dict(k_pages=kp, v_pages=vp, page_size=PS, layer=1)

    def q4(*shape):
        return inp.randn(*shape, dtype=dtype) * LONG_Q_SCALE

    start = torch.tensor([1024, 2048], dtype=torch.int32, device="cuda")
    return [
        (f"tp{tp}_rank_decode_after_1024", "paged_decode",
         dict(base, q=q4(S, h, D), page_table=table, lengths=lens,
              k_cur=inp.randn(S, kvh, D, dtype=dtype), v_cur=inp.randn(S, kvh, D, dtype=dtype)),
         list(range(S))),
        (f"tp{tp}_rank_chunk_1024_after_1024", "prefix_chunk",
         dict(base, q=q4(1, 1024, h, D), table_row=table[3], start=start[0:1],
              total_len=start[1:2], k_cur=inp.randn(1024, kvh, D, dtype=dtype),
              v_cur=inp.randn(1024, kvh, D, dtype=dtype)), 1024),
        (f"tp{tp}_rank_verify_8x5_after_1024", "prefix_chunk_slots",
         dict(base, q=q4(S, 5, h, D), page_table=table, lengths=lens,
              k_cur=inp.randn(S, 5, kvh, D, dtype=dtype),
              v_cur=inp.randn(S, 5, kvh, D, dtype=dtype)), None),
    ]


def _tp_rank_tree_cases(torch, inp: Inputs, dtype, tol: float, tp: int = 2) -> list:
    """The tree leg at llama3:8b's per-rank heads under `tp` against its
    plain version: S 8, N 6 (the default topology, K 4 and width 2), slots
    from 0 to 4,000 cached tokens, q scaled by LONG_Q_SCALE and held to the
    row-relative error."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import ragged_paged_attention_ref
    from gridllm_torch.ops.spec import tree_topology

    h, kvh, dname = H // tp, KVH // tp, str(dtype).split(".")[-1]
    parents = tree_topology(4, 2)
    n = len(parents)
    depths, anc, bits = _tree_operands(parents)
    lengths = [0, 5, 63, 64, 1024, 1024, 2000, 4000]
    kp, vp = (inp.randn(1, S * MAXP, PS, kvh, D, dtype=dtype) for _ in range(2))
    kw = dict(q_group=inp.randn(S, n, h, D, dtype=dtype) * LONG_Q_SCALE,
              page_table=inp.page_table(lengths, extra=n),
              group_lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
              k_group=inp.randn(S, n, kvh, D, dtype=dtype),
              v_group=inp.randn(S, n, kvh, D, dtype=dtype))
    _, og = ck.ragged_attention(kp, vp, PS, layer=0, tree_pos=depths, tree_bits=bits, **kw)
    _, wg = ragged_paged_attention_ref(kp, vp, PS, layer=0, tree_pos=depths, tree_mask=anc,
                                       **kw)
    torch.cuda.synchronize()
    rel, err = _rel_err(og, wg), _max_err(og, wg)
    check(rel <= tol, f"ragged_attention tree {dname} tp{tp} rank: relative err {rel} > {tol}")
    return [{"kernel": "ragged_attention.tree", "dtype": dname, "case": f"tp{tp}_rank_s8_n{n}",
             "H": h, "KVH": kvh, "max_rel_err": rel, "max_abs_err": err}]


def _decode_cases(inp: Inputs, dtype):
    """(name, kwargs, rows_to_compare) cases of paged_decode: an empty slot,
    page straddles, the capacity edge (8192 = MAXP * PS), window, softcap,
    and the pool holding the current token (no k_cur)."""
    torch = inp.torch
    lengths = [0, 1, 63, 64, 65, 700, 1500, MAXP * PS]
    kp, vp = inp.pools(2, dtype)
    table = inp.page_table(lengths, extra=1)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    base = dict(q=inp.randn(S, H, D, dtype=dtype), k_pages=kp, v_pages=vp, page_table=table,
                lengths=lens, page_size=PS, layer=1)
    cur = dict(k_cur=inp.randn(S, KVH, D, dtype=dtype), v_cur=inp.randn(S, KVH, D, dtype=dtype))
    every, nonempty = list(range(S)), [i for i, ln in enumerate(lengths) if ln > 0]
    return [
        ("merge_cur", {**base, **cur}, every),
        ("merge_cur_window", {**base, **cur, "window": 100}, every),
        ("merge_cur_softcap_window", {**base, **cur, "softcap": 30.0, "window": 64}, every),
        ("in_pool", base, nonempty),   # a length-0 row is unspecified here
    ]


def _chunk_cases(inp: Inputs, dtype):
    """(name, kwargs, valid_rows) cases of prefix_chunk: a prefill chunk of
    1024 (page-aligned start, ragged length), the first chunk (start 0),
    verify width C = 5 at a start that is not page-aligned (device-side
    start, total = start + C), with window and softcap, an empty slot, and
    a chunk already in the pool (no k_cur), and a chunk whose last 64 rows
    pass the table's capacity (their fresh K/V cut)."""
    torch = inp.torch
    kp, vp = inp.pools(2, dtype)
    table = inp.page_table([4000] * S, extra=1)
    row = table[2]

    def chunk(c, start, total, fresh=True, row=row):
        kw = dict(q=inp.randn(1, c, H, D, dtype=dtype), k_pages=kp, v_pages=vp,
                  table_row=row, start=start, total_len=total, page_size=PS, layer=1)
        if fresh:
            kw.update(k_cur=inp.randn(c, KVH, D, dtype=dtype),
                      v_cur=inp.randn(c, KVH, D, dtype=dtype))
        return kw

    dev_start = torch.tensor([1029], dtype=torch.int32, device="cuda")
    empty = torch.full((MAXP,), -1, dtype=torch.int32, device="cuda")
    return [
        ("c1024", chunk(1024, 1024, 1024 + 1000), 1000),
        ("c1024_first", chunk(1024, 0, 1024), 1024),
        ("c5_verify", chunk(5, dev_start, None), 5),
        ("c5_window_softcap", {**chunk(5, 1029, 1034), "window": 100, "softcap": 30.0}, 5),
        ("c5_empty_slot", chunk(5, 0, 5, row=empty), 5),
        ("c256_window", {**chunk(256, 130, 130 + 256), "window": 300}, 256),
        ("c64_in_pool", chunk(64, 640, 704, fresh=False), 64),
        ("c128_past_capacity", chunk(128, MAXP * PS - 64, MAXP * PS + 64,
                                     row=inp.page_table([MAXP * PS] * S)[0]), 128),
    ]


# prefix_chunk's routes with rows of their own in the kernels line
_PER_PHASE_LEGS = ("prefix_chunk.slots", "prefix_chunk.chunk")
LONG_REL_TOL = 5e-3   # bf16 row-relative bound of the per-phase long cases at q x 4


def _verify_cases(inp: Inputs, dtype):
    """(name, kwargs) cases of prefix_chunk_slots, the per-phase verify:
    S = 8 slots x T = 5 candidates at lengths from 0 to the capacity (a
    slot whose last three candidates pass it, a full slot) on a shuffled
    table with -1 past each slot's pages; window with softcap."""
    torch = inp.torch
    t = 5
    lengths = [0, 1, 63, 64, 700, 1500, MAXP * PS - 2, MAXP * PS]
    kp, vp = inp.pools(2, dtype)
    base = dict(q=inp.randn(S, t, H, D, dtype=dtype), k_pages=kp, v_pages=vp,
                page_table=inp.page_table(lengths, extra=t),
                lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"), page_size=PS,
                k_cur=inp.randn(S, t, KVH, D, dtype=dtype),
                v_cur=inp.randn(S, t, KVH, D, dtype=dtype), layer=1)
    return [("verify", base),
            ("verify_window_softcap", {**base, "window": 100, "softcap": 30.0})]


def _per_phase_long_cases(inp: Inputs, dtype):
    """(name, wrapper, kwargs, rows) cases of the per-phase routes at long
    positions, q scaled by LONG_Q_SCALE (row-relative error): on a
    400-entry table (25,600 tokens), paged_decode of eight slots from 0 to
    24,000 cached tokens and at the capacity in both modes, the verify over
    the same slots (T = 5), and a 1,024-row chunk after 16,384 cached
    tokens with fresh K/V (valid 1,000 rows) and in the pool."""
    torch = inp.torch
    n_pool, maxp = 1024, 400
    kp, vp = (inp.randn(1, n_pool, PS, KVH, D, dtype=dtype) for _ in range(2))
    row = torch.randperm(n_pool, generator=inp.gen, device="cuda")[:maxp].to(torch.int32)
    table = row[None].expand(S, maxp).contiguous()
    lengths = [24000, 16384 + 1023, 0, 65, 5000, 12000, maxp * PS - 2, maxp * PS]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    nonempty = [i for i, ln in enumerate(lengths) if ln > 0]
    base = dict(k_pages=kp, v_pages=vp, page_size=PS, layer=0)

    def q4(*shape):
        return inp.randn(*shape, dtype=dtype) * LONG_Q_SCALE

    dec = dict(base, q=q4(S, H, D), page_table=table, lengths=lens)
    cur = dict(k_cur=inp.randn(S, KVH, D, dtype=dtype), v_cur=inp.randn(S, KVH, D, dtype=dtype))
    ver = dict(base, q=q4(S, 5, H, D), page_table=table, lengths=lens,
               k_cur=inp.randn(S, 5, KVH, D, dtype=dtype),
               v_cur=inp.randn(S, 5, KVH, D, dtype=dtype))
    start = torch.tensor([16384, 16384 + 1000], dtype=torch.int32, device="cuda")
    chunk = dict(base, q=q4(1, 1024, H, D), table_row=row, start=start[0:1],
                 total_len=start[1:2])
    fresh = dict(k_cur=inp.randn(1024, KVH, D, dtype=dtype),
                 v_cur=inp.randn(1024, KVH, D, dtype=dtype))
    every = list(range(S))
    return [
        ("decode_merge_cur_0_to_25600", "paged_decode", {**dec, **cur}, every),
        ("decode_in_pool_0_to_25600", "paged_decode", dec, nonempty),
        ("verify_0_to_25600", "prefix_chunk_slots", ver, every),
        ("chunk_1024_after_16384", "prefix_chunk", {**chunk, **fresh}, 1000),
        ("chunk_1024_in_pool_after_16384", "prefix_chunk", chunk, 1000),
    ]


def _per_phase_plain(torch, wrapper: str, kw: dict):
    """The plain version of one per-phase wrapper call (the pool's layer
    selected as the wrapper selects it)."""
    from gridllm_torch.ops.attention import (
        _prefix_chunk_ref,
        paged_attention_decode_ref,
        paged_attention_verify_ref,
    )

    kw = dict(kw)
    layer = kw.pop("layer")
    kp, vp = kw.pop("k_pages")[layer], kw.pop("v_pages")[layer]
    cap, window = kw.pop("softcap", 0.0), kw.pop("window", 0)
    opts = dict(logit_softcap=cap, window=window)
    if wrapper == "paged_decode":
        return paged_attention_decode_ref(kw["q"], kp, vp, kw["page_table"], kw["lengths"], PS,
                                          k_cur=kw.get("k_cur"), v_cur=kw.get("v_cur"), **opts)
    if wrapper == "prefix_chunk_slots":
        return paged_attention_verify_ref(kw["q"], kp, vp, kw["page_table"], kw["lengths"], PS,
                                          kw["k_cur"], kw["v_cur"], **opts)
    start = int(kw["start"])   # the plain version takes host ints
    total = start + kw["q"].shape[1] if kw["total_len"] is None else int(kw["total_len"])
    return _prefix_chunk_ref(kw["q"], kp, vp, kw["table_row"], start, total, PS,
                             k_cur=kw.get("k_cur"), v_cur=kw.get("v_cur"), **opts)


def _per_phase_kernel_cases(torch, inp: Inputs, dtype, tol: float, cases: list,
                            errs: dict) -> None:
    """paged_decode (_decode_cases), prefix_chunk (_chunk_cases: the
    tensor-core route in bf16, the CUDA-core route in float32, each held to
    its leg counter), the verify over slots (_verify_cases) against their
    plain versions, max abs error within `tol`; then _per_phase_long_cases
    held to the row-relative error (LONG_REL_TOL in bf16)."""
    from gridllm_torch.ops import cuda_kernels as ck

    dname = str(dtype).split(".")[-1]
    bf16 = dtype == torch.bfloat16
    chunk_leg = "prefix_chunk.chunk" if bf16 else "prefix_chunk.chunk_cores"
    runs = ([(name, "paged_decode", kw, rows, False)
             for name, kw, rows in _decode_cases(inp, dtype)]
            + [(name, "prefix_chunk", kw, valid, False)
               for name, kw, valid in _chunk_cases(inp, dtype)]
            + [(name, "prefix_chunk_slots", kw, None, False)
               for name, kw in _verify_cases(inp, dtype)]
            + [(*case, True) for case in _per_phase_long_cases(inp, dtype)]
            + [(*case, True) for case in _tp_rank_per_phase_cases(inp, dtype)])
    for name, wrapper, kw, rows, relative in runs:
        kw = dict(kw)
        cap, window = kw.pop("softcap", 0.0), kw.pop("window", 0)
        legs0 = dict(ck.LEG_LAUNCHES)
        got = getattr(ck, wrapper)(**kw, softcap=cap, window=window)
        want = _per_phase_plain(torch, wrapper, {**kw, "softcap": cap, "window": window})
        torch.cuda.synchronize()
        if wrapper == "paged_decode":
            got, want = got[rows], want[rows]
        elif wrapper == "prefix_chunk":
            got, want = got[:, :rows], want[:, :rows]
        leg = "prefix_chunk.slots" if wrapper == "prefix_chunk_slots" else (
            chunk_leg if wrapper == "prefix_chunk" else None)
        if leg is not None:
            check(ck.LEG_LAUNCHES[leg] == legs0[leg] + 1,
                  f"{wrapper} {dname} {name}: did not take the {leg} route")
        err, rel = _max_err(got, want), _rel_err(got, want)
        bound = (LONG_REL_TOL if bf16 else tol) if relative else tol
        cases.append({"kernel": wrapper, "dtype": dname, "case": name, "route": leg,
                      "max_abs_err": err, "max_rel_err": rel,
                      "held_to": "max_rel_err" if relative else "max_abs_err", "bound": bound})
        check((rel if relative else err) <= bound, f"{wrapper} {dname} {name}: "
              f"{'relative ' if relative else ''}err {rel if relative else err} > {bound}")
        if bf16:
            kernel = "prefix_chunk" if wrapper == "prefix_chunk_slots" else wrapper
            for key in {kernel, leg} - {None}:
                errs[key] = max(errs[key], err)
        del got, want, kw
    del runs
    torch.cuda.empty_cache()



def _wide_group_cases(torch, inp: Inputs, dtype):
    """(name, pools, kwargs) chain groups wider than 32 tokens: the draft
    model's Td = 64 catch-up chunk at D = 64 (llama3.2:1b: H = 32,
    KVH = 8) and Td = 33 at D = 128, each on an fp pool and an int8 pool,
    at layer 1 of 2, q scaled by LONG_Q_SCALE, slots from 0 to 4000
    cached tokens."""
    lengths = [0, 1, 63, 64, 65, 700, 1500, 4000]
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    cases = []
    for td, d in ((64, 64), (33, D)):
        table = inp.page_table(lengths, extra=td)
        kw = dict(q_group=inp.randn(S, td, H, d, dtype=dtype) * LONG_Q_SCALE, page_table=table,
                  group_lengths=glens, k_group=inp.randn(S, td, KVH, d, dtype=dtype),
                  v_group=inp.randn(S, td, KVH, d, dtype=dtype))
        shape = (2, S * MAXP, PS, KVH, d)
        fp = (inp.randn(*shape, dtype=dtype), inp.randn(*shape, dtype=dtype))
        cases.append((f"chain_td{td}_d{d}_fp", fp, kw))
        del fp
        cases.append((f"chain_td{td}_d{d}_int8", _quant_pools(torch, inp, 2, S * MAXP, d=d), kw))
    return cases


def _tp_rank_writes(torch, inp: Inputs, dtype, tp: int, n_kv: int = KVH,
                    d: int = D) -> list[dict]:
    """Both KV writes into one rank's pool under `tp` (n_kv/tp kv heads of
    dim d; llama3:8b's by default): a decode step's rows (an inactive
    slot, the capacity edge) and a page-aligned chunk, exact on the valid
    region."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.kvcache import write_decode, write_prefill

    kvh, dname = n_kv // tp, str(dtype).split(".")[-1]
    shape = (2, S * MAXP, PS, kvh, d)
    kp, vp = inp.randn(*shape, dtype=dtype), inp.randn(*shape, dtype=dtype)
    positions = torch.tensor([0, 63, 64, 700, 8191, 8192, 100, 5000],
                             dtype=torch.int32, device="cuda")
    table = inp.page_table([int(p) for p in positions.tolist()], extra=1)
    active = torch.tensor([True] * 6 + [False, True], device="cuda")
    kn, vn = inp.randn(2, S, kvh, d, dtype=dtype), inp.randn(2, S, kvh, d, dtype=dtype)
    want = write_decode(kp.clone(), vp.clone(), kn, vn, table, positions, active, PS)
    got = ck.paged_write_decode(kp.clone(), vp.clone(), kn, vn, table, positions, active, PS)
    torch.cuda.synchronize()
    out = [{"kernel": "paged_write_decode", "dtype": dname, "tp_rank_of": tp, "KVH": kvh, "D": d,
            "exact": bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))}]
    t, start, length = 1024, 128, 1000
    row = table[3]
    kn, vn = inp.randn(2, t, kvh, d, dtype=dtype), inp.randn(2, t, kvh, d, dtype=dtype)
    want = write_prefill(kp.clone(), vp.clone(), kn, vn, row, start, length, PS)
    got = ck.paged_write_chunk(kp.clone(), vp.clone(), kn, vn, row, start, length, PS)
    torch.cuda.synchronize()
    last = start + length - 1
    keep = torch.ones(kp.shape[1:3], dtype=torch.bool, device="cuda")
    keep[int(row[last // PS]), last % PS + 1:] = False
    out.append({"kernel": "paged_write_chunk", "dtype": dname, "tp_rank_of": tp, "KVH": kvh, "D": d,
                "exact": bool(torch.equal(got[0][:, keep], want[0][:, keep])
                              and torch.equal(got[1][:, keep], want[1][:, keep]))})
    for c in out:
        check(c["exact"], f"{c['kernel']} {dname} tp{tp} rank: pools differ")
    return out


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _rel_err(a, b) -> float:
    """Largest error of one output row (the D values of one token and
    head) relative to the plain version's row: max ||a - b|| / ||b||."""
    if not a.numel():
        return 0.0
    a, b = a.float(), b.float()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max())


# a batch of 32 embedding rows in one length bucket: 20 texts of mixed
# lengths and 12 padding rows of length 1 (engine.embed's batch of 32)
EMBED_B32_LENS = [1000, 1, 513, 257, 777, 1024, 300, 1, 999, 640, 258, 1, 700, 512, 1,
                  900, 333, 1, 1023, 450, 1, 600, 1, 800, 1, 260, 1, 1, 950, 1, 555, 1]

# The prefill kernel (csrc/flash_prefill.cu, both prefill wrappers) at the
# edges of its tile plan: (name, (T, H, KVH, D), seq_lens, window, softcap).
# Head groupings G = 1 (llava:7b's multi-head stack), 2 (qwen3:0.6b), 7 at
# D = 128 (qwen2.5:7b), 7 at D = 64 (qwen2.5:0.5b) and 8 (llama3:70b); T
# not a multiple of the 128-key tile; seq_len inside a tile and exactly at
# a tile edge; a window across tile edges with softcap; B = 32 with a
# length per row, rows of length 1 among them (decoder embeddings).
PREFILL_CASES = (
    ("llava_7b_mha_g1_t600", (600, 32, 32, 128), [583], 0, 0.0),
    ("embed_b32_ragged_lens", (1024, H, KVH, D), EMBED_B32_LENS, 0, 0.0),
    ("qwen3_0.6b_g2_t1000", (1000, 16, 8, 128), [1000], 0, 0.0),
    ("qwen2.5_7b_g7_len_at_tile_edge", (700, 28, 4, 128), [640], 0, 0.0),
    ("qwen2.5_0.5b_g7_d64_len_inside_tile", (900, 14, 2, 64), [777], 0, 0.0),
    ("llama3_70b_g8_batch_of_two", (520, 64, 8, 128), [520, 300], 0, 0.0),
    ("window_across_tiles_softcap", (1100, H, KVH, D), [1100], 200, 30.0),
    ("t129_len128", (129, H, KVH, D), [128], 0, 0.0),
    # llama3:8b's share of one rank under tp = 2 (H 16, KVH 4) and tp = 4
    # (H 8, KVH 2): the tp phase's prompt buckets
    ("llama3_8b_tp2_rank_t1024", (1024, H // 2, KVH // 2, D), [1000], 0, 0.0),
    ("llama3_8b_tp4_rank_t600", (600, H // 4, KVH // 4, D), [583], 0, 0.0),
    # a rank of gemma2:9b (H 8, KVH 4, D 256, its window and softcap) and
    # of llava:7b (H 16, KVH 16: G = 1) under tp = 2
    ("gemma2_9b_tp2_rank_t1024", (1024, 8, 4, 256), [1000], 4096, 50.0),
    ("llava_7b_tp2_rank_g1_t600", (600, 16, 16, D), [583], 0, 0.0),
)
# the tensor-parallel degrees whose per-rank shapes the kernels phase holds
TP_DEGREES = (2, 4)


def phase_kernels(torch) -> dict:
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_ref, ragged_paged_attention_ref
    from gridllm_torch.ops.kernels import F32_TOL, by_name
    from gridllm_torch.ops.kvcache import QuantPages, write_decode, write_prefill

    inp = Inputs(torch, SEED)
    errs = {k: 0.0 for k in [*ck.LAUNCHES, "ragged_attention.chunk", *_PER_PHASE_LEGS]}
    cases = []
    bf16_tol = by_name("ragged_attention").atol
    check(bf16_tol == by_name("flash_prefill").atol, "attention tolerances differ")
    for dtype, tol in ((torch.bfloat16, bf16_tol), (torch.float32, F32_TOL)):
        dname = str(dtype).split(".")[-1]
        # flash_prefill: the engine's buckets, a batch of two with one
        # ragged seq_len, one window + softcap case
        for t, lens, window, cap in ((64, [64], 0, 0.0), (256, [200, 256], 0, 0.0),
                                     (1024, [1024], 0, 0.0), (256, [256], 96, 30.0)):
            b = len(lens)
            q = inp.randn(b, t, H, D, dtype=dtype)
            k = inp.randn(b, t, KVH, D, dtype=dtype)
            v = inp.randn(b, t, KVH, D, dtype=dtype)
            sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ck.flash_prefill(q, k, v, sl, softcap=cap, window=window)
            want = attention_prefill_ref(q, k, v, sl, logit_softcap=cap, window=window)
            torch.cuda.synchronize()
            err = max(_max_err(got[i, :ln], want[i, :ln]) for i, ln in enumerate(lens))
            cases.append({"kernel": "flash_prefill", "dtype": dname, "T": t, "seq_lens": lens,
                          "window": window, "softcap": cap, "max_abs_err": err})
            check(err <= tol, f"flash_prefill {dname} T={t}: err {err} > {tol}")
            if dtype == torch.bfloat16:
                errs["flash_prefill"] = max(errs["flash_prefill"], err)
        # both prefill wrappers at the edges of the tile plan, q x 4, held to
        # the row-relative error
        for name, (t, h, kvh, d), lens, window, cap in PREFILL_CASES:
            b = len(lens)
            q = inp.randn(b, t, h, d, dtype=dtype) * LONG_Q_SCALE
            k, v = inp.randn(b, t, kvh, d, dtype=dtype), inp.randn(b, t, kvh, d, dtype=dtype)
            sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            want = attention_prefill_ref(q, k, v, sl, logit_softcap=cap, window=window)
            for kernel in ("flash_prefill", "flash_prefill_streamed"):
                got = getattr(ck, kernel)(q, k, v, sl, softcap=cap, window=window)
                torch.cuda.synchronize()
                rel = max(_rel_err(got[i, :ln], want[i, :ln]) for i, ln in enumerate(lens))
                err = max(_max_err(got[i, :ln], want[i, :ln]) for i, ln in enumerate(lens))
                cases.append({"kernel": kernel, "dtype": dname, "case": name, "T": t, "H": h,
                              "KVH": kvh, "D": d, "seq_lens": lens, "window": window,
                              "softcap": cap, "max_rel_err": rel, "max_abs_err": err})
                check(rel <= tol, f"{kernel} {dname} {name}: relative err {rel} > {tol}")
                if dtype == torch.bfloat16:
                    errs[kernel] = max(errs[kernel], err)
            del q, k, v, got, want
        _per_phase_kernel_cases(torch, inp, dtype, tol, cases, errs)
        for name, kw, valid, relative in _ragged_cases(inp, dtype):
            kw = dict(kw)
            cap, window = kw.pop("softcap", 0.0), kw.pop("window", 0)
            oc, og = ck.ragged_attention(**kw, softcap=cap, window=window)
            wc, wg = ragged_paged_attention_ref(**kw, logit_softcap=cap, window=window)
            torch.cuda.synchronize()
            pairs = [(o, w) for o, w in ((oc, wc), (og, wg)) if o is not None]
            if oc is not None:
                pairs[0] = (oc[:, :valid], wc[:, :valid])
            err = max(_max_err(o, w) for o, w in pairs)
            rel = max(_rel_err(o, w) for o, w in pairs)
            cases.append({"kernel": "ragged_attention", "dtype": dname, "case": name,
                          "max_abs_err": err, "max_rel_err": rel, "held_to": (
                              "max_rel_err" if relative else "max_abs_err")})
            got = rel if relative else err
            check(got <= tol, f"ragged_attention {dname} {name}: "
                  f"{'relative ' if relative else ''}err {got} > {tol}")
            if dtype == torch.bfloat16:
                errs["ragged_attention"] = max(errs["ragged_attention"], err)
                if oc is not None:   # the chunk region: the tensor-core kernel in bf16
                    errs["ragged_attention.chunk"] = max(errs["ragged_attention.chunk"],
                                                         _max_err(*pairs[0]))
            del oc, og, wc, wg, pairs
        del kw
        # chain groups of any width (the wrapper once refused Td > 32)
        for name, (kp, vp), kw in _wide_group_cases(torch, inp, dtype):
            scales = {}
            if isinstance(kp, QuantPages):
                scales = dict(k_scale=kp.scale, v_scale=vp.scale)
            _, og = ck.ragged_attention(kp.data if scales else kp, vp.data if scales else vp,
                                        PS, layer=1, **scales, **kw)
            _, wg = ragged_paged_attention_ref(kp, vp, PS, layer=1, **kw)
            torch.cuda.synchronize()
            rel, err = _rel_err(og, wg), _max_err(og, wg)
            cases.append({"kernel": "ragged_attention", "dtype": dname, "case": name,
                          "max_rel_err": rel, "max_abs_err": err})
            check(rel <= tol, f"ragged_attention {dname} {name}: relative err {rel} > {tol}")
            del kp, vp, kw, og, wg
        torch.cuda.empty_cache()
        # paged_write_decode: inactive slot, capacity edge, unmapped page
        kp, vp = inp.pools(2, dtype)
        positions = torch.tensor([0, 63, 64, 700, 8191, 8192, 100, 5000],
                                 dtype=torch.int32, device="cuda")
        table = inp.page_table([int(p) for p in positions.tolist()], extra=1)
        table[7, :] = -1  # slot 7 unmapped
        active = torch.tensor([True] * 6 + [False, True], device="cuda")
        kn, vn = inp.randn(2, S, KVH, D, dtype=dtype), inp.randn(2, S, KVH, D, dtype=dtype)
        want_k, want_v = write_decode(kp.clone(), vp.clone(), kn, vn, table, positions,
                                      active, PS)
        got_k, got_v = ck.paged_write_decode(kp, vp, kn, vn, table, positions, active, PS)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got_k, want_k) and torch.equal(got_v, want_v))
        cases.append({"kernel": "paged_write_decode", "dtype": dname, "exact": exact})
        check(exact, f"paged_write_decode {dname}: pools differ")
        # a verify step's flattened rows: K+1 = 5 per slot, past-capacity
        # rows and the inactive slot dropped
        t = 5
        kn, vn = inp.randn(2, S * t, KVH, D, dtype=dtype), inp.randn(2, S * t, KVH, D, dtype=dtype)
        pos = (positions[:, None] + torch.arange(t, device="cuda", dtype=torch.int32)).reshape(-1)
        want_k, want_v = write_decode(want_k, want_v, kn, vn, table.repeat_interleave(t, 0),
                                      pos, active.repeat_interleave(t), PS)
        got_k, got_v = ck.paged_write_decode(got_k, got_v, kn, vn, table, pos, active, PS,
                                             rows_per_slot=t)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got_k, want_k) and torch.equal(got_v, want_v))
        cases.append({"kernel": "paged_write_decode", "dtype": dname, "rows_per_slot": t,
                      "exact": exact})
        check(exact, f"paged_write_decode {dname} rows_per_slot={t}: pools differ")
        del kp, vp, want_k, want_v, got_k, got_v

        # paged_write_chunk: page-aligned start, ragged length; compare all
        # rows except the padded tail of the last written page
        kp, vp = inp.pools(2, dtype)
        t, start, length = 1024, 128, 700
        table = inp.page_table([start + t] * S)
        row = table[3]
        kn, vn = inp.randn(2, t, KVH, D, dtype=dtype), inp.randn(2, t, KVH, D, dtype=dtype)
        want_k, want_v = write_prefill(kp.clone(), vp.clone(), kn, vn, row, start, length, PS)
        got_k, got_v = ck.paged_write_chunk(kp, vp, kn, vn, row, start, length, PS)
        torch.cuda.synchronize()
        last = start + length - 1
        tail_page, tail_off = int(row[last // PS]), last % PS
        keep = torch.ones(kp.shape[1:3], dtype=torch.bool, device="cuda")
        keep[tail_page, tail_off + 1:] = False
        exact = bool(torch.equal(got_k[:, keep], want_k[:, keep])
                     and torch.equal(got_v[:, keep], want_v[:, keep]))
        cases.append({"kernel": "paged_write_chunk", "dtype": dname, "exact": exact})
        check(exact, f"paged_write_chunk {dname}: valid region differs")
        del kp, vp, want_k, want_v, got_k, got_v
        for tp in TP_DEGREES:
            cases += _tp_rank_writes(torch, inp, dtype, tp)
        cases += _tp_rank_writes(torch, inp, dtype, 2, *TP_RANK_MODELS["gemma2_9b"][1:3])
        cases += _tp_rank_tree_cases(torch, inp, dtype,
                                     bf16_tol if dtype == torch.bfloat16 else F32_TOL)
    torch.cuda.empty_cache()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_cases.json").write_text(json.dumps(cases, indent=1))
    return {"phase": "kernels", "cases": len(cases), "max_abs_err_bf16": errs}


def _n_splits(ck, s: int, n_table: int, dev) -> int | None:
    """Spans per (slot, kv head) of a decode group at llama3:8b widths;
    None for a tree whose kernels have no split (timing an older checkout's
    package through these helpers)."""
    if not hasattr(ck, "ragged_split_count"):
        return None
    return ck.ragged_split_count(s, KVH, n_table, H // KVH, D, ck._sm_count(dev), PS)


def _ragged_host_us(torch, inp: Inputs, calls: int = 500) -> float:
    """The ragged_attention wrapper's host time per call, in microseconds:
    back-to-back decode-group calls of one slot at 64 cached tokens (its
    kernel far shorter than the host's work), on the host's clock up to a
    synchronize."""
    from gridllm_torch.ops import cuda_kernels as ck

    bf16 = torch.bfloat16
    kp, vp = (inp.randn(1, 4, PS, KVH, D, dtype=bf16) for _ in range(2))
    kw = dict(k_pages=kp, v_pages=vp, page_size=PS, q_group=inp.randn(1, 1, H, D, dtype=bf16),
              page_table=torch.arange(4, dtype=torch.int32, device="cuda")[None],
              group_lengths=torch.tensor([64], dtype=torch.int32, device="cuda"),
              k_group=inp.randn(1, 1, KVH, D, dtype=bf16),
              v_group=inp.randn(1, 1, KVH, D, dtype=bf16), layer=0)
    for _ in range(20):
        ck.ragged_attention(**kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        ck.ragged_attention(**kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _ragged_timing(torch, inp: Inputs) -> dict:
    """ragged_attention at the main path's shapes (bf16, llama3:8b widths,
    a shuffled page table): the decode group of 8 slots at 1,024 cached
    tokens (the kernels line's row) and of one slot at 24,000; the chunk
    region (C = 1,024) after 1,024 and after 16,384 cached tokens; the
    verify width (one slot, Td = 5 after 1,024). Each with its bound and,
    as a yardstick
    only, SDPA on K/V gathered beforehand into one dense tensor (no paging:
    not a library call for the same function). The decode group's first
    call runs under torch.cuda.set_sync_debug_mode("error"): the wrapper
    makes no host sync."""
    import torch.nn.functional as F

    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import ragged_paged_attention_ref
    from gridllm_torch.ops.kvcache import gather_kv

    bf16 = torch.bfloat16
    n_pool, maxp = 1024, 400   # 64 MB of pool per layer and K/V; 25,600 tokens per row
    kp, vp = (inp.randn(1, n_pool, PS, KVH, D, dtype=bf16) for _ in range(2))
    perm = torch.randperm(n_pool, generator=inp.gen, device="cuda").to(torch.int32)
    res = {}

    def group_kw(lengths, table):
        s = len(lengths)
        return dict(k_pages=kp, v_pages=vp, page_size=PS, q_group=inp.randn(s, 1, H, D, dtype=bf16),
                    page_table=table, group_lengths=torch.tensor(lengths, dtype=torch.int32,
                                                                 device="cuda"),
                    k_group=inp.randn(s, 1, KVH, D, dtype=bf16),
                    v_group=inp.randn(s, 1, KVH, D, dtype=bf16), layer=0)

    def group_bound(lengths):
        keys = sum(lengths) + len(lengths)
        return bound_ms(keys * KVH * D * 2 * 2 + 2 * len(lengths) * H * D * 2, 4 * H * D * keys)

    def sdpa_group(kw):
        """SDPA of each slot's decode query over its K/V gathered into one
        dense [S, KVH, length + 1, D] (every slot of one length)."""
        s, length = kw["q_group"].shape[0], int(kw["group_lengths"][0])
        ks, vs = [], []
        for i in range(s):
            k, v = gather_kv(kp[0], vp[0], kw["page_table"][i], PS)
            ks.append(torch.cat([k[:length], kw["k_group"][i]]))
            vs.append(torch.cat([v[:length], kw["v_group"][i]]))
        k, v = torch.stack(ks).transpose(1, 2), torch.stack(vs).transpose(1, 2)
        q = kw["q_group"].transpose(1, 2)
        return time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True))

    # decode group, 8 slots x 1,024 cached tokens (128-page table rows)
    table8 = perm[:S * MAXP].reshape(S, MAXP).contiguous()
    kw = group_kw([1024] * S, table8)
    _no_host_sync(torch, lambda: ck.ragged_attention(**kw))
    b, op = group_bound([1024] * S)
    res["ragged_attention"] = {
        "shape": f"decode group S={S} Td=1 context=1024 bf16", "no_host_sync": True,
        "n_splits": _n_splits(ck, S, MAXP, kp.device),
        "ms": time_ms(torch, lambda: ck.ragged_attention(**kw)),
        "device_ms": device_ms(torch, lambda: ck.ragged_attention(**kw)),
        "plain_ms": time_ms(torch, lambda: ragged_paged_attention_ref(**kw), iters=3),
        "library_ms": None, "sdpa_gathered_ms": sdpa_group(kw),
        "bound_ms": b, "bound_by": op,
    }
    # one slot at 24,000 cached tokens (a 400-page table row)
    kw24 = group_kw([24000], perm[:maxp][None].contiguous())
    b, op = group_bound([24000])
    res["ragged_attention"]["one_slot_24000"] = {
        "n_splits": _n_splits(ck, 1, maxp, kp.device),
        "ms": time_ms(torch, lambda: ck.ragged_attention(**kw24)),
        "device_ms": device_ms(torch, lambda: ck.ragged_attention(**kw24)),
        "sdpa_gathered_ms": sdpa_group(kw24), "bound_ms": b, "bound_by": op,
    }

    # the chunk region, C = 1,024 after 1,024 and after 16,384 cached tokens
    c = 1024
    for start in (1024, 16384):
        row = perm[:maxp].clone()
        row[-(-(start + c) // PS):] = -1
        q_c = inp.randn(1, c, H, D, dtype=bf16)
        k_c, v_c = inp.randn(c, KVH, D, dtype=bf16), inp.randn(c, KVH, D, dtype=bf16)
        ckw = dict(k_pages=kp, v_pages=vp, page_size=PS, q_chunk=q_c, chunk_row=row,
                   chunk_start=start, chunk_total=start + c, k_chunk=k_c, v_chunk=v_c, layer=0)
        b, op = bound_ms((2 * q_c.numel() + (start + c) * KVH * D * 2) * 2,
                         4 * H * D * c * (start + (c + 1) / 2))
        k_all, v_all = gather_kv(kp[0], vp[0], row, PS)
        k_all = torch.cat([k_all[:start], k_c])[None].transpose(1, 2)
        v_all = torch.cat([v_all[:start], v_c])[None].transpose(1, 2)
        mask = (torch.arange(start + c, device="cuda")[None, :]
                <= start + torch.arange(c, device="cuda")[:, None])
        qt = q_c.transpose(1, 2)
        entry = {"ms": time_ms(torch, lambda: ck.ragged_attention(**ckw)),
                 "device_ms": device_ms(torch, lambda: ck.ragged_attention(**ckw)),
                 "sdpa_gathered_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                     qt, k_all, v_all, attn_mask=mask, enable_gqa=True)),
                 "bound_ms": b, "bound_by": op}
        if start == 1024:
            entry["plain_ms"] = time_ms(torch, lambda: ragged_paged_attention_ref(**ckw), iters=3)
        res["ragged_attention"][f"chunk_1024_after_{start}"] = entry
        del k_all, v_all, mask, ckw
    # the verify width: Td = K+1 = 5 after 1024 cached tokens, one slot
    c, glen = 5, kw["group_lengths"][:1]
    gkw = dict(k_pages=kp, v_pages=vp, page_size=PS, q_group=inp.randn(1, c, H, D, dtype=bf16),
               page_table=table8[:1], group_lengths=glen,
               k_group=inp.randn(1, c, KVH, D, dtype=bf16),
               v_group=inp.randn(1, c, KVH, D, dtype=bf16), layer=0)
    vb, vop = bound_ms(*_group_work([1024], c, H, KVH, D, list(range(1, c + 1))))
    res["ragged_attention"]["verify_td5_one_slot"] = {
        "ms": time_ms(torch, lambda: ck.ragged_attention(**gkw)),
        "device_ms": device_ms(torch, lambda: ck.ragged_attention(**gkw)),
        "bound_ms": vb, "bound_by": vop,
    }
    # the kernels line's row of the chunk kernel
    chunk = res["ragged_attention"]["chunk_1024_after_1024"]
    res["ragged_attention.chunk"] = {
        "shape": "chunk region C=1024 after 1024 cached tokens bf16", "ms": chunk["ms"],
        "device_ms": chunk["device_ms"],
        "plain_ms": chunk["plain_ms"], "library_ms": None,
        "sdpa_gathered_ms": chunk["sdpa_gathered_ms"], "bound_ms": chunk["bound_ms"],
        "bound_by": chunk["bound_by"]}
    res["ragged_attention"]["chunk_region_ms"] = chunk["ms"]
    res["ragged_attention"]["host_us_per_call"] = _ragged_host_us(torch, inp)
    res["ragged_attention"]["chunk_region_bound_ms"] = chunk["bound_ms"]
    del kp, vp
    return res


def _per_phase_timing(torch, inp: Inputs) -> dict:
    """The per-phase routes at the main path's shapes (bf16, llama3:8b
    widths, a shuffled page table, the rows of PERF.md's prediction table),
    through wrappers that every tree of the port has, so an older
    checkout's kernels can be timed by the same code (`--turns`):
    paged_decode of 8 slots at 1,024 cached tokens and of one slot at
    24,000; the verify attention of one layer, 8 slots x K+1 = 5 after
    1,024 (ops.attention.paged_attention_verify: one prefix_chunk launch
    for all slots here, one per slot before); prefix_chunk's chunk of
    1,024 after 1,024 and after 16,384 cached tokens, start and total as
    device scalars (as the model passes them). Each row: `ms` (CUDA events
    over back-to-back calls: the host's time where a wrapper outlasts its
    kernel), `device_ms` (the profiler's kernel time) and the bound; the
    plain version at the first shape of each wrapper. The first call of
    each runs under torch.cuda.set_sync_debug_mode("error")."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import (
        _prefix_chunk_ref,
        paged_attention_decode_ref,
        paged_attention_verify,
        paged_attention_verify_ref,
    )

    bf16 = torch.bfloat16
    n_pool, maxp = 1024, 400
    kp, vp = (inp.randn(1, n_pool, PS, KVH, D, dtype=bf16) for _ in range(2))
    perm = torch.randperm(n_pool, generator=inp.gen, device="cuda").to(torch.int32)
    table8 = perm[:S * MAXP].reshape(S, MAXP).contiguous()
    lens8 = torch.full((S,), 1024, dtype=torch.int32, device="cuda")
    res = {}

    def row(fn, nbytes, flops, **extra):
        b, op = bound_ms(nbytes, flops)
        return {**extra, "ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn),
                "bound_ms": b, "bound_by": op, "library_ms": None}

    def decode_kw(lengths, table):
        s = len(lengths)
        return dict(q=inp.randn(s, H, D, dtype=bf16), k_pages=kp, v_pages=vp, page_table=table,
                    lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
                    page_size=PS, k_cur=inp.randn(s, KVH, D, dtype=bf16),
                    v_cur=inp.randn(s, KVH, D, dtype=bf16), layer=0)

    dkw = decode_kw([1024] * S, table8)
    _no_host_sync(torch, lambda: ck.paged_decode(**dkw))
    res["paged_decode"] = row(
        lambda: ck.paged_decode(**dkw), *_group_work([1024] * S, 1, H, KVH, D, [1]),
        shape=f"decode S={S} context=1024 bf16", no_host_sync=True,
        plain_ms=time_ms(torch, lambda: paged_attention_decode_ref(
            dkw["q"], kp[0], vp[0], table8, dkw["lengths"], PS, k_cur=dkw["k_cur"],
            v_cur=dkw["v_cur"]), iters=3))
    dkw24 = decode_kw([24000], perm[:maxp][None].contiguous())
    res["paged_decode"]["one_slot_24000"] = row(
        lambda: ck.paged_decode(**dkw24), *_group_work([24000], 1, H, KVH, D, [1]))

    t = 5
    vkw = dict(q=inp.randn(S, t, H, D, dtype=bf16), k_pages=kp, v_pages=vp, page_table=table8,
               lengths=lens8, page_size=PS, k_cur=inp.randn(S, t, KVH, D, dtype=bf16),
               v_cur=inp.randn(S, t, KVH, D, dtype=bf16), layer=0)
    _no_host_sync(torch, lambda: paged_attention_verify(**vkw))
    res["prefix_chunk.slots"] = row(
        lambda: paged_attention_verify(**vkw),
        *_group_work([1024] * S, t, H, KVH, D, list(range(1, t + 1))),
        shape=f"verify attention of one layer, S={S} x T={t} after 1024 cached tokens bf16",
        no_host_sync=True,
        plain_ms=time_ms(torch, lambda: paged_attention_verify_ref(
            vkw["q"], kp[0], vp[0], table8, lens8, PS, vkw["k_cur"], vkw["v_cur"]), iters=3))

    c = 1024
    for start in (1024, 16384):
        chunk_row = perm[:maxp].clone()
        chunk_row[-(-(start + c) // PS):] = -1
        bounds = torch.tensor([start, start + c], dtype=torch.int32, device="cuda")
        pkw = dict(q=inp.randn(1, c, H, D, dtype=bf16), k_pages=kp, v_pages=vp,
                   table_row=chunk_row, start=bounds[0:1], total_len=bounds[1:2], page_size=PS,
                   k_cur=inp.randn(c, KVH, D, dtype=bf16),
                   v_cur=inp.randn(c, KVH, D, dtype=bf16), layer=0)
        work = ((2 * c * H * D + (start + c) * KVH * D * 2) * 2,
                4 * H * D * c * (start + (c + 1) / 2))
        if start == 1024:
            _no_host_sync(torch, lambda: ck.prefix_chunk(**pkw))
            res["prefix_chunk"] = row(
                lambda: ck.prefix_chunk(**pkw), *work, no_host_sync=True,
                shape=f"chunk C={c} after {start} cached tokens bf16",
                plain_ms=time_ms(torch, lambda: _prefix_chunk_ref(
                    pkw["q"], kp[0], vp[0], chunk_row, start, start + c, PS,
                    k_cur=pkw["k_cur"], v_cur=pkw["v_cur"]), iters=3))
        else:
            res["prefix_chunk"][f"after_{start}"] = row(lambda: ck.prefix_chunk(**pkw), *work)
    # the kernels line's row of the tensor-core chunk route: the same call
    res["prefix_chunk.chunk"] = {k: v for k, v in res["prefix_chunk"].items()
                                 if not k.startswith("after_")}
    del kp, vp
    torch.cuda.empty_cache()
    return res


def phase_timing(torch) -> dict:
    import torch.nn.functional as F

    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_ref
    from gridllm_torch.ops.kvcache import write_decode, write_prefill

    inp = Inputs(torch, SEED + 1)
    bf16 = torch.bfloat16
    res = {}

    # flash_prefill: the 1024-token bucket, full length
    t = 1024
    q = inp.randn(1, t, H, D, dtype=bf16)
    k, v = inp.randn(1, t, KVH, D, dtype=bf16), inp.randn(1, t, KVH, D, dtype=bf16)
    sl = torch.tensor([t], dtype=torch.int32, device="cuda")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    b, op = bound_ms((2 * q.numel() + k.numel() + v.numel()) * 2,
                     4 * H * D * t * (t + 1) / 2)
    res["flash_prefill"] = {
        "shape": f"q[1,{t},{H},{D}] bf16",
        "ms": time_ms(torch, lambda: ck.flash_prefill(q, k, v, sl)),
        "flash_prefill_streamed_ms": time_ms(torch, lambda: ck.flash_prefill_streamed(
            q, k, v, sl)),
        "plain_ms": time_ms(torch, lambda: attention_prefill_ref(q, k, v, sl), iters=5),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bound_ms": b, "bound_by": op,
    }
    del q, k, v, qt, kt, vt

    res.update(_ragged_timing(torch, inp))
    torch.cuda.empty_cache()
    res.update(_per_phase_timing(torch, inp))

    # KV writes on the engine's full pool: 32 layers x 1024 pages x 64 rows
    n_layers = 32
    kp = torch.zeros((n_layers, S * MAXP, PS, KVH, D), dtype=bf16, device="cuda")
    vp = torch.zeros_like(kp)
    row_bytes = KVH * D * 2
    positions = torch.tensor([1024 + 7 * s for s in range(S)], dtype=torch.int32, device="cuda")
    table = inp.page_table([int(p) for p in positions.tolist()], extra=1)
    active = torch.ones(S, dtype=torch.bool, device="cuda")
    kn, vn = inp.randn(n_layers, S, KVH, D, dtype=bf16), inp.randn(n_layers, S, KVH, D, dtype=bf16)
    srange = torch.arange(S, device="cuda")
    pidx = table[srange, (positions // PS).long()].long()
    off = (positions % PS).long()

    def lib_decode():
        kp[:, pidx, off] = kn
        vp[:, pidx, off] = vn

    def kernel_decode():
        ck.paged_write_decode(kp, vp, kn, vn, table, positions, active, PS)

    # the kernel and index_put_ in turns (kernel, library) x 3, CUDA events
    # around the calls only
    turns = [(time_ms(torch, kernel_decode), time_ms(torch, lib_decode)) for _ in range(3)]
    b, op = bound_ms(2 * 2 * n_layers * S * row_bytes, 0)
    res["paged_write_decode"] = {
        "shape": f"pool[{n_layers},{S * MAXP},{PS},{KVH},{D}] S={S} bf16",
        "ms": statistics.median(t for t, _ in turns),
        "plain_ms": time_ms(torch, lambda: write_decode(kp, vp, kn, vn, table, positions,
                                                        active, PS)),
        "library_ms": statistics.median(t for _, t in turns),
        "turns_ms": [t for t, _ in turns], "turns_library_ms": [t for _, t in turns],
        "device_ms": device_ms(torch, kernel_decode),
        "library_device_ms": device_ms(torch, lib_decode),
        "bound_ms": b, "bound_by": op,
    }

    # its launch floor: the same kernel at 1 layer x 1 row, device time from
    # the profiler, read in two turns beside the main path's 32 x 8
    def one_row():
        ck.paged_write_decode(kp[:1], vp[:1], kn[:1, :1], vn[:1, :1], table[:1],
                              positions[:1], active[:1], PS)

    floor = [(device_ms(torch, kernel_decode), device_ms(torch, one_row)) for _ in range(2)]
    res["paged_write_decode"]["launch_floor"] = {
        "device_ms_32x8": [t for t, _ in floor], "device_ms_1x1": [t for _, t in floor],
        "ratio_32x8_over_1x1": (statistics.median(t for t, _ in floor)
                                / statistics.median(t for _, t in floor)),
        "bound_ms_1x1": bound_ms(2 * 2 * row_bytes, 0)[0],
    }
    t = 1024
    row = table[0]
    kn, vn = inp.randn(n_layers, t, KVH, D, dtype=bf16), inp.randn(n_layers, t, KVH, D, dtype=bf16)
    cpos = torch.arange(t, device="cuda")
    cpage, coff = row[(cpos // PS).long()].long(), (cpos % PS).long()

    def lib_chunk():
        kp[:, cpage, coff] = kn
        vp[:, cpage, coff] = vn

    b, op = bound_ms(2 * 2 * n_layers * t * row_bytes, 0)
    res["paged_write_chunk"] = {
        "shape": f"chunk[{n_layers},{t},{KVH},{D}] start=0 bf16",
        "ms": time_ms(torch, lambda: ck.paged_write_chunk(kp, vp, kn, vn, row, 0, t, PS)),
        "plain_ms": time_ms(torch, lambda: write_prefill(kp, vp, kn, vn, row, 0, t, PS)),
        "library_ms": time_ms(torch, lib_chunk),
        "bound_ms": b, "bound_by": op,
    }
    del kp, vp, kn, vn
    torch.cuda.empty_cache()
    return {"phase": "timing", "card": card_line(), "kernels": res}


def phase_model(torch) -> dict:
    """The model's paged entry points against its cache-free forward, in
    both attention modes."""
    import dataclasses

    from gridllm_torch.models.configs import get_config
    from gridllm_torch.models.llama import Llama
    from gridllm_torch.ops.kernels import F32_TOL
    from gridllm_torch.ops.kvcache import PagedKVCache, rollback_to_length

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    cfg = dataclasses.replace(get_config("llama3:8b"), num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = Llama(cfg, dtype=torch.float32, device="cuda").init_params(gen)
    n, k1 = 320, 5
    toks = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    want = model(toks[None])[0]                  # [n, V], flash_prefill
    cache = PagedKVCache.create(cfg.num_layers, 32, PS, KVH, D, 4, 8, dtype=torch.float32,
                                device="cuda")
    rows = torch.arange(32, device="cuda", dtype=torch.int32).reshape(4, 8)
    errs = {"ragged": [], "per_phase": []}
    cur = torch.zeros(4, dtype=torch.int32, device="cuda")

    def err(mode, got, pos):
        errs[mode].append(float((got - want[pos]).abs().max()))

    def prefill_decode(mode, slot, p0, p1):
        """`slot` prefills a 192-token prompt in the 256 bucket, then
        decodes positions p0..p1-1."""
        logits, _ = model.prefill(torch.cat([toks[:p0], toks[:64] * 0]), p0, cache, slot,
                                  rows[slot])
        err(mode, logits, p0 - 1)
        active = torch.zeros(4, dtype=torch.bool, device="cuda")
        active[slot] = True
        for pos in range(p0, p1):
            cur[slot] = toks[pos]
            logits, _ = model.decode_step(cur, cache, active)
            err(mode, logits[slot], pos)

    def verify(mode, slots, steps):
        """`steps` verify steps of K+1 = 5 true candidates for `slots`, each
        committed in full."""
        active = torch.zeros(4, dtype=torch.bool, device="cuda")
        active[slots] = True
        for _ in range(steps):
            lens = cache.lengths.tolist()
            cand = torch.zeros((4, k1), dtype=torch.int32, device="cuda")
            for s in slots:
                cand[s] = toks[lens[s]:lens[s] + k1]
            logits, _ = model.verify_step(cand, cache, active)
            for s in slots:
                for j in range(k1):
                    err(mode, logits[s, j], lens[s] + j)
            rollback_to_length(cache, cache.lengths + k1 * active.to(torch.int32))

    # ragged attention: slot 0 decodes 192..255, slot 1 admits the same
    # sequence in two 64-token chunks beside slot 0's decode rows (mixed
    # steps, positions 256 and 257), then two verify steps for both
    prefill_decode("ragged", 0, 192, 256)
    active = torch.tensor([True, False, False, False], device="cuda")
    for start, pos in ((0, 256), (64, 257)):
        cur[0] = toks[pos]
        chunk_logits, dec_logits, _ = model.mixed_step(
            toks[start:start + 64], start, 64, 1, rows[1], cur, cache, active)
        err("ragged", chunk_logits, start + 63)
        err("ragged", dec_logits[0], pos)
    verify("ragged", [0, 1], 2)
    # per-phase kernels, a second model over a copy of the weights and the
    # same cache: slot 2 decodes 192..223 through paged_decode, slot 3
    # admits in two prefill_chunk calls (prefix_chunk), then two verify
    # steps for both (prefix_chunk once per layer for both slots)
    ragged = model
    model = Llama(cfg, dtype=torch.float32, device="cuda", ragged_attention=False)
    model.load_state_dict(ragged.state_dict())
    del ragged
    prefill_decode("per_phase", 2, 192, 224)
    for start in (0, 64):
        logits, _ = model.prefill_chunk(toks[start:start + 64], start, 64, cache, 3, rows[3])
        err("per_phase", logits, start + 63)
    verify("per_phase", [2, 3], 2)
    torch.cuda.synchronize()
    worst = {mode: max(e) for mode, e in errs.items()}
    check(max(worst.values()) <= F32_TOL, f"model: paged path differs from forward by {worst}")
    del model, cache, want
    torch.cuda.empty_cache()
    return {"phase": "model", "config": "llama3:8b, 2 layers, float32",
            "logit_rows_compared": {m: len(e) for m, e in errs.items()},
            "max_abs_err": worst}


def _prompt(rng, n_bytes: int) -> str:
    words = []
    while sum(len(w) + 1 for w in words) < n_bytes:
        words.append("".join(chr(97 + rng.randrange(26)) for _ in range(rng.randrange(2, 9))))
    return " ".join(words)[:n_bytes]


class Served:
    """One engine behind its runner thread, with every logits tensor its
    model entry points compute checked on the device (one flag, no sync per
    step) and its shape recorded, and its calls counted (`calls`). While
    `admissions` is a list, each admission's last-prompt-token logits are
    appended to it as (entry point, float32 copy, the prompt's tokens for
    a bucket prefill)."""

    def __init__(self, torch, engine):
        self.torch, self.engine = torch, engine
        self.vocab = engine.cfg.vocab_size
        self.finite = torch.ones((), dtype=torch.bool, device=engine.device)
        self.logit_shapes: set[tuple[int, ...]] = set()
        self.admissions: list | None = None
        self.calls: dict[str, int] = {}
        for name, n_logits in (("prefill", 1), ("prefill_chunk", 1), ("decode_step", 1),
                               ("verify_step", 1), ("mixed_step", 2)):
            self._watch(name, n_logits)

    def _watch(self, name: str, n_logits: int) -> None:
        fn = getattr(self.engine.model, name)

        def watched(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls[name] = self.calls.get(name, 0) + 1
            for logits in out[:n_logits]:
                self.logit_shapes.add(tuple(logits.shape))
                self.finite.logical_and_(self.torch.isfinite(logits).all())
            if self.admissions is not None and name in ADMISSIONS:
                tokens = args[0][:args[1]].clone() if name == "prefill" else None
                self.admissions.append((name, out[0].float().clone(), tokens))
            return out

        setattr(self.engine.model, name, watched)

    def run(self, prompts: list[tuple[str, int]]) -> tuple[list, float]:
        """Greedy requests from one thread each; (results, wall seconds)."""
        from gridllm_torch.engine import GenerationRequest

        results: list = [None] * len(prompts)

        def one(i: int, text: str, n: int) -> None:
            opts = {"temperature": 0.0, "num_predict": n}
            results[i] = self.engine.generate(GenerationRequest(id=f"r{i}", prompt=text,
                                                                options=opts))

        threads = [threading.Thread(target=one, args=(i, p, n))
                   for i, (p, n) in enumerate(prompts)]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(not any(th.is_alive() for th in threads), "serve: a request hung")
        for (text, n), res in zip(prompts, results):
            self.finished(res, n, f"prompt of {len(text)} bytes")
        return results, time.perf_counter() - t_start

    def finished(self, res, n, what):
        # num_predict tokens, or fewer when the model sampled EOS (no stop
        # sequences are set, so "stop" can only mean EOS)
        ok = res is not None and (
            (res.done_reason == "length" and res.eval_count == n)
            or (res.done_reason == "stop" and res.eval_count < n))
        check(ok, f"serve: {what} finished {getattr(res, 'done_reason', None)!r} "
                  f"with {getattr(res, 'eval_count', None)} of {n} tokens "
                  f"({getattr(res, 'error', '')})")
        check(all(0 <= t < self.vocab for t in res.token_ids),
              f"serve: {what} token out of range")

    def summary(self, batch: list, wall: float, want_shapes: set) -> dict:
        """Check the logits and sum up one engine setting's run."""
        check(self.logit_shapes == want_shapes, f"serve: logits of shapes {self.logit_shapes}")
        check(bool(self.finite), "serve: non-finite logits on the served path")
        stats = self.engine.batch_state()["specDecode"]
        tokens = sum(r.eval_count for r in batch)
        out = {"requests": len(batch), "tokens": tokens, "wall_s": wall,
               "tokens_per_s": tokens / wall,
               "ttft_ms_median": statistics.median(r.prompt_eval_duration_ns / 1e6
                                                   for r in batch),
               "logit_shapes": sorted(self.logit_shapes)}
        if stats:
            out.update(spec_acceptance=stats["accepted"] / max(stats["proposed"], 1),
                       tokens_per_verify_step=stats["emitted"] / max(stats["steps"], 1),
                       spec_stats=stats)
        return out


# the model entry points whose first output is an admitted prompt's
# last-token logits [V]
ADMISSIONS = ("prefill", "prefill_chunk", "mixed_step")
# a solo prompt's last-token logits from its cold bucket prefill (bf16,
# flash_prefill) against the cache-free forward of its tokens with the plain
# attention, and against its warm admission from the prefix cache (the
# uncached rows in the ragged chunk region; the cached rows are the cold
# run's, so this one sees only the uncached rows): row-relative error. On
# an H100, bf16 rounding of the routes through 32 layers of random weights
# departs by 0.016-0.017; a prefill kernel whose diagonal tiles skip the
# causal mask departs from the plain forward by 0.96 (PERF.md, PR 6).
SERVE_WARM_COLD_REL = 0.1


def _free(torch, served: Served) -> None:
    served.engine.stop()
    check(not served.engine.running, "serve: runner did not stop")
    del served.engine
    gc.collect()
    torch.cuda.empty_cache()


# the kernels each engine setting's path must launch and must not launch;
# the counts are set to 0 just before a setting serves and read just after
# ragged_attention's regions: the chunk region on the tensor cores and the
# groups launch in every ragged setting (a prompt longer than one chunk, a
# prefix-cache repeat); the CUDA-core chunk route never does in bf16
_RAGGED = {"ragged_attention", "ragged_attention.chunk", "ragged_attention.group"}
_PATHS = {
    "spec_ragged": ({"flash_prefill", "paged_write_decode", "paged_write_chunk"} | _RAGGED,
                    {"paged_decode", "prefix_chunk", "flash_prefill_streamed",
                     "ragged_attention.chunk_cores"}),
    "plain_ragged": ({"flash_prefill", "paged_write_decode", "paged_write_chunk"} | _RAGGED,
                     {"paged_decode", "prefix_chunk", "flash_prefill_streamed",
                      "ragged_attention.chunk_cores"}),
    # prefix_chunk's routes: every chunk on the tensor cores in bf16, the
    # verify steps all slots in one launch
    "spec_per_phase": ({"flash_prefill", "prefix_chunk", "prefix_chunk.chunk",
                        "prefix_chunk.slots", "paged_write_decode", "paged_write_chunk"},
                       {"paged_decode", "flash_prefill_streamed", "prefix_chunk.chunk_cores",
                        "ragged_attention.chunk_cores"} | _RAGGED),
    "plain_per_phase": ({"flash_prefill", "paged_decode", "prefix_chunk", "prefix_chunk.chunk",
                         "paged_write_decode", "paged_write_chunk"},
                        {"flash_prefill_streamed", "prefix_chunk.chunk_cores",
                         "prefix_chunk.slots", "ragged_attention.chunk_cores"} | _RAGGED),
    "long_spec_ragged": ({"flash_prefill_streamed", "flash_prefill", "paged_write_decode",
                          "paged_write_chunk"} | _RAGGED,
                         {"paged_decode", "prefix_chunk", "ragged_attention.chunk_cores"}),
}
# the setting whose launches the kernels line reports for each kernel
_CARRIER = {"flash_prefill": "spec_ragged", "ragged_attention": "spec_ragged",
            "ragged_attention.chunk": "spec_ragged",
            "paged_write_decode": "spec_ragged", "paged_write_chunk": "spec_ragged",
            "paged_decode": "plain_per_phase", "prefix_chunk": "spec_per_phase",
            "prefix_chunk.slots": "spec_per_phase", "prefix_chunk.chunk": "spec_per_phase"}


def _path_launches(ck, name: str, srv: Served) -> dict:
    """Check one setting's launch counts against its path; return them."""
    counts = ck.launch_counts()
    must, never = _PATHS[name]
    check(all(counts[k] > 0 for k in must),
          f"serve {name}: a kernel of its path never launched: {counts}")
    check(all(counts[k] == 0 for k in never),
          f"serve {name}: a kernel of another path launched: {counts}")
    layers, slots = srv.engine.cfg.num_layers, srv.engine.config.max_slots
    steps = srv.engine.spec_stats["steps"]
    check((steps > 0) == srv.engine.config.spec_decode, f"serve {name}: {steps} verify steps")
    # a verify step is one attention launch per layer, all slots in it
    # (ragged_attention, or prefix_chunk's slots route per-phase)
    if name in ("spec_ragged", "long_spec_ragged"):
        check(counts["ragged_attention"] >= layers * steps,
              f"serve {name}: {counts['ragged_attention']} ragged launches, {steps} verify steps")
    if name == "spec_per_phase":
        check(counts["prefix_chunk.slots"] == layers * steps,
              f"serve {name}: {counts['prefix_chunk.slots']} prefix_chunk.slots launches, "
              f"{steps} verify steps of {layers} layers ({slots} slots)")
    return counts


def _serve_prompts():
    """(rng, short prompts, a prompt longer than one chunk, the eight
    concurrent requests), from SEED."""
    import random

    rng = random.Random(SEED)
    short = [_prompt(rng, n) for n in (40, 150, 300, 700, 90, 220, 500)]
    long_prompt = _prompt(rng, 1500)   # > prefill_chunk: chunked admission
    # eight at once: every slot of the engine (max_slots = 8) fills
    batch_a = [(short[0], 32), (short[1], 48), (short[2], 64), (short[3], 40),
               (short[4], 56), (short[5], 32), (short[6], 48), (long_prompt, 64)]
    return rng, short, long_prompt, batch_a


def phase_serve(torch) -> dict:
    """llama3:8b bf16 in four engine settings, one after the other: the
    default (spec decode on, ragged attention on), the same requests with
    spec decode off, then spec on and spec off with the per-phase kernels.
    Each setting's kernel launches are counted from 0 and held to its path."""
    from unittest import mock

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.models import llama
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_ref

    t0 = time.perf_counter()
    srv = Served(torch, InferenceEngine(EngineConfig(model="llama3:8b"), device="cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    vocab, slots = srv.vocab, srv.engine.config.max_slots
    k1 = srv.engine.config.spec_k + 1
    srv.engine.start()
    rng, short, long_prompt, batch_a = _serve_prompts()
    ck.reset_launch_counts()
    res_a, wall_a = srv.run(batch_a)
    # a repeat of the 300-byte prompt hits the prefix cache and replays
    # through the ragged chunk region, next to a new short prompt
    res_b, wall_b = srv.run([(short[2], 64), (_prompt(rng, 120), 32)])
    check(res_b[0].cached_tokens > 0, "serve: the repeat did not hit the prefix cache")

    def matching(cold, warm) -> str:   # tokens equal up to the first that differs
        n = 0
        for a, b in zip(cold.token_ids, warm.token_ids):
            if a != b:
                break
            n += 1
        return f"{n}/{len(warm.token_ids)}"
    # greedy determinism: the same short prompt twice, each alone on the
    # engine, takes the same kernels at the same shapes
    solo = [srv.run([(short[0], 32)])[0][0] for _ in range(2)]
    check(solo[0].token_ids == solo[1].token_ids, "serve: greedy repeat differs")
    # and a new prompt alone, cold, then warm from the prefix cache twice.
    # The two warm runs replay the same cached rows through the same
    # kernels at the same shapes and must give the same stream. The cold
    # run attends the prompt in the bucket prefill's bf16 tensor-core
    # kernel, the warm runs its uncached rows in the chunk region's
    # float32 CUDA-core math, so bf16 rounding departs between their
    # streams. Their first logits are held to each other, and the cold
    # ones to the cache-free forward with the plain attention, within
    # SERVE_WARM_COLD_REL; the replay phase holds the warm stream to the
    # cold one in float32
    fresh = _prompt(rng, 300)
    solo_warm, admitted = [], []
    for _ in range(3):
        srv.admissions = []
        solo_warm.append(srv.run([(fresh, 64)])[0][0])
        admitted.append(srv.admissions)
    srv.admissions = None
    check(solo_warm[0].cached_tokens == 0
          and solo_warm[1].cached_tokens == solo_warm[2].cached_tokens > 0,
          "serve: the solo repeats did not hit the prefix cache")
    check(solo_warm[1].token_ids == solo_warm[2].token_ids,
          "serve: solo warm repeat differs from the warm run before it")
    routes = [[name for name, *_ in a] for a in admitted]
    check(routes == [["prefill"], ["mixed_step"], ["mixed_step"]],
          f"serve: solo admissions took {routes}")
    (_, cold_logits, ids), (_, warm_logits, _), (_, warm2_logits, _) = (a[0] for a in admitted)
    with mock.patch.object(llama, "attention_prefill", attention_prefill_ref), \
            torch.no_grad():   # the runner is idle: nothing else calls the model
        plain_logits = srv.engine.model.forward(ids[None])[0, -1].float()
    rel = {"cold_vs_plain_forward": _rel_err(cold_logits, plain_logits),
           "warm_vs_cold": _rel_err(warm_logits, cold_logits)}
    check(torch.equal(warm_logits, warm2_logits),
          "serve: solo warm admission logits differ from the warm run before it")
    check(max(rel.values()) <= SERVE_WARM_COLD_REL,
          f"serve: solo admission logits depart (row-relative) {rel} > {SERVE_WARM_COLD_REL}")
    top_cold, top_warm = (x.topk(10).indices.tolist() for x in (cold_logits, warm_logits))
    solo += solo_warm
    all_res = res_a + res_b
    settings = {"spec_ragged": {
        **srv.summary(res_a, wall_a, {(vocab,), (slots, vocab), (slots, k1, vocab)}),
        "ttft_ms_median_all": statistics.median(r.prompt_eval_duration_ns / 1e6
                                                for r in all_res),
        "batch_b": {"requests": len(res_b), "wall_s": wall_b,
                    "cached_tokens": res_b[0].cached_tokens},
        "batched_warm_repeat_tokens_matching_cold": matching(res_a[2], res_b[0]),
        "solo_warm_repeat_tokens_matching_cold": matching(solo_warm[0], solo_warm[1]),
        "solo_warm_repeats_equal": True,
        "solo_admission_logits": {**rel, "limit": SERVE_WARM_COLD_REL,
                                     "top1_equal": top_cold[0] == top_warm[0],
                                     "top10_shared": len(set(top_cold) & set(top_warm))},
        "eos_finishes": sum(r.done_reason == "stop" for r in all_res + solo),
        "launches": _path_launches(ck, "spec_ragged", srv)}}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _free(torch, srv)
    n_requests = len(all_res) + len(solo)

    # the same eight requests with speculative decoding off: pipelined
    # decode blocks, what the default gives up for speculation
    srv = Served(torch, InferenceEngine(EngineConfig(model="llama3:8b", spec_decode=False),
                                        device="cuda"))
    srv.engine.start()
    ck.reset_launch_counts()
    res, wall = srv.run(batch_a)
    settings["plain_ragged"] = {**srv.summary(res, wall, {(vocab,), (slots, vocab)}),
                                "launches": _path_launches(ck, "plain_ragged", srv)}
    _free(torch, srv)
    n_requests += len(res)
    settings["spec_ragged"]["tokens_per_s_over_spec_off"] = (
        settings["spec_ragged"]["tokens_per_s"] / settings["plain_ragged"]["tokens_per_s"])

    # the per-phase kernels: a prompt longer than one chunk beside a short
    # one (prefill_chunk twice), then the short one again from the prefix
    # cache (prefill_chunk), with spec decode on (verify steps of one
    # prefix_chunk launch per layer) and off (paged_decode)
    mid = _prompt(rng, 200)
    for name, spec, shapes in (("spec_per_phase", True, {(vocab,), (slots, k1, vocab)}),
                               ("plain_per_phase", False, {(vocab,), (slots, vocab)})):
        srv = Served(torch, InferenceEngine(EngineConfig(
            model="llama3:8b", spec_decode=spec, ragged_attention=False), device="cuda"))
        srv.engine.start()
        ck.reset_launch_counts()
        res, wall = srv.run([(long_prompt, 64), (mid, 48)])
        (repeat,), _ = srv.run([(mid, 48)])
        check(repeat.cached_tokens > 0, f"serve {name}: the repeat missed the prefix cache")
        settings[name] = {**srv.summary(res, wall, shapes), "repeat_cached_tokens":
                          repeat.cached_tokens, "launches": _path_launches(ck, name, srv)}
        _free(torch, srv)
        n_requests += len(res) + 1
    return {
        "phase": "serve", "model": "llama3:8b", "dtype": "bfloat16",
        "device": torch.cuda.get_device_name(0), "card": card_line(), "load_s": load_s,
        "requests": n_requests, "settings": settings,
        "launches": {k: settings[carrier]["launches"][k] for k, carrier in _CARRIER.items()},
        "launches_from": _CARRIER, "peak_memory_gb": peak_gb,
    }


# ---------------------------------------------------------------------------
# worker: the port's WorkerService on the port's in-memory bus
# ---------------------------------------------------------------------------

WORKER_MODEL = "llama3:8b"
WORKER_ID = "smoke-worker"
# decode progress (snapshot tokens) before the kill
KILL_AFTER_TOKENS = 24


class _DeadableBus:
    """A worker's view of the bus. Setting `dead` is a SIGKILL as the
    cluster sees it: every publish, hash write and heartbeat key of this
    worker vanishes (tests/test_fault_tolerance.py's PartitionableBus)."""

    def __init__(self, inner):
        self._inner = inner
        self.dead = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def publish(self, channel, message):
        return 0 if self.dead else await self._inner.publish(channel, message)

    async def hset(self, key, field, value):
        if not self.dead:
            await self._inner.hset(key, field, value)

    async def set_with_expiry(self, key, value, ttl_s):
        if not self.dead:
            await self._inner.set_with_expiry(key, value, ttl_s)


class _Job:
    """One job as the stand-in sees it: the text its stream frames put
    together (a frame's offset trims what the client already has, as the
    gateway does), the time to its first frame, and its JobResult."""

    def __init__(self, req, loop):
        self.req, self.text = req, ""
        self.t_submit = self.t_first = None
        self.frames = 0
        self.result = loop.create_future()
        self.subs: list = []

    async def on_frame(self, _ch, raw):
        from gridllm_torch.utils.types import StreamChunk

        chunk = StreamChunk.model_validate_json(raw)
        if not chunk.response:
            return
        self.frames += 1
        if self.t_first is None:
            self.t_first = time.perf_counter()
        off = len(self.text) if chunk.offset is None else chunk.offset
        check(off <= len(self.text), f"worker: job {self.req.id} stream has a gap "
                                     f"(frame at {off}, {len(self.text)} chars so far)")
        self.text += chunk.response[len(self.text) - off:]

    async def on_result(self, _ch, raw):
        from gridllm_torch.utils.types import JobResult

        if not self.result.done():
            self.result.set_result(JobResult.model_validate_json(raw))


class _StandIn:
    """The scheduler's part on the bus, as the worker phase needs it (the
    smoke run may not import the JAX package's scheduler): assignments on
    `worker_job_channel`, frames from `job_stream_channel`, results from
    `job_result_channel` and `job:failed` (NACKs included), the newest
    resume snapshot per job from `job:snapshot`, and cancellations."""

    def __init__(self, bus):
        self.bus = bus
        self.jobs: dict[str, _Job] = {}
        self.snapshots: dict[str, dict] = {}

    async def start(self):
        from gridllm_torch.bus.base import CH_JOB_FAILED, CH_JOB_SNAPSHOT

        await self.bus.subscribe(CH_JOB_SNAPSHOT, self._on_snapshot)
        await self.bus.subscribe(CH_JOB_FAILED, self._on_failed)

    async def _on_snapshot(self, _ch, raw):
        snap = json.loads(raw)
        prev = self.snapshots.get(snap["jobId"])
        if prev is None or len(snap["tokens"]) >= len(prev["tokens"]):
            self.snapshots[snap["jobId"]] = snap

    async def _on_failed(self, _ch, raw):
        job = self.jobs.get(json.loads(raw)["jobId"])
        if job is not None:
            await job.on_result(_ch, raw)

    async def submit(self, worker_id, req, job=None):
        """Assign `req` to `worker_id`; a resubmission passes its _Job, so
        the text put together so far carries on."""
        import asyncio

        from gridllm_torch.bus.base import (
            job_result_channel,
            job_stream_channel,
            worker_job_channel,
        )
        from gridllm_torch.utils.types import JobAssignment

        if job is None:
            job = self.jobs[req.id] = _Job(req, asyncio.get_running_loop())
            job.subs = [await self.bus.subscribe(job_stream_channel(req.id), job.on_frame),
                        await self.bus.subscribe(job_result_channel(req.id), job.on_result)]
        else:
            job.req, job.result = req, asyncio.get_running_loop().create_future()
        job.t_submit = time.perf_counter()
        assignment = JobAssignment(jobId=req.id, workerId=worker_id, request=req)
        await self.bus.publish(worker_job_channel(worker_id), json.dumps(
            {"type": "job_assignment", "job": assignment.model_dump()}))
        return job

    async def cancel(self, worker_id, job_id):
        from gridllm_torch.bus.base import worker_job_channel

        await self.bus.publish(worker_job_channel(worker_id), json.dumps(
            {"type": "job_cancellation", "jobId": job_id}))


def _worker_request(rid, n, prompt=None, messages=None, resume=None):
    from gridllm_torch.utils.types import InferenceRequest

    md = {"requestType": "chat" if messages else "inference"}
    if resume is not None:
        md["resume"] = resume
    return InferenceRequest(id=rid, model=WORKER_MODEL, prompt=prompt, messages=messages,
                            stream=True, options={"temperature": 0, "num_predict": n},
                            metadata=md)


def _final_text(res) -> str:
    r = res.response
    return (r.message or {}).get("content", "") if r.message else (r.response or "")


class _PlainWatch:
    """Counts calls of the kernels' plain versions (KERNELS `plain`) with a
    tensor on the card, wherever the port's modules bind them: the main
    path runs none of them."""

    def __init__(self, torch):
        from gridllm_torch.models import llama
        from gridllm_torch.ops import attention, cuda_kernels, kvcache
        from gridllm_torch.ops.kernels import KERNELS

        self.torch = torch
        names = {spec.plain.split(":")[1] for spec in KERNELS} | {"paged_attention_verify_ref"}
        self.counts = dict.fromkeys(sorted(names), 0)
        self.patched = [(mod, name, getattr(mod, name))
                        for mod in (attention, kvcache, cuda_kernels, llama)
                        for name in names if hasattr(mod, name)]

    def _wrap(self, name, fn):
        def watched(*args, **kwargs):
            if any(isinstance(a, self.torch.Tensor) and a.is_cuda
                   for a in (*args, *kwargs.values())):
                self.counts[name] += 1
            return fn(*args, **kwargs)
        return watched

    def __enter__(self):
        for mod, name, fn in self.patched:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.patched:
            setattr(mod, name, fn)


def _capture_results(engine) -> dict:
    """The engine's own result of every request (done_reason, cached tokens)
    by request id, from a wrapper around its submit."""
    results: dict = {}
    submit = engine.submit

    def wrapped(req):
        user_cb = req.on_chunk

        def cb(delta, done, res):
            if done and res is not None:
                results[req.id] = res
            if user_cb:
                user_cb(delta, done, res)

        req.on_chunk = cb
        submit(req)

    engine.submit = wrapped
    return results


async def _wait(cond, what: str, timeout_s: float = 300.0) -> None:
    import asyncio

    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout_s, f"worker: timed out waiting for {what}")
        await asyncio.sleep(0.005)


async def _kill_and_resume(bus, standin, engine, workers, tag, prompt, n):
    """An undisturbed greedy job alone on the engine, then the same job
    again, its worker killed (its bus goes dead, and the engine drops the
    generation, as the killed process would) once its snapshot holds
    KILL_AFTER_TOKENS tokens; the stand-in resubmits it to a second
    WorkerService on the same engine with the last snapshot as
    metadata.resume. Returns the undisturbed and the resumed runs."""
    import asyncio

    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker.service import WorkerService

    victim = workers[0]
    ref = await standin.submit(victim.worker_id, _worker_request(f"{tag}-ref", n, prompt))
    ref_res = await asyncio.wait_for(ref.result, 600)
    check(ref_res.success and ref.text == _final_text(ref_res),
          f"worker {tag}: undisturbed run {ref_res.error}")
    rid = f"{tag}-kill"
    job = await standin.submit(victim.worker_id, _worker_request(rid, n, prompt))
    await _wait(lambda: len(standin.snapshots.get(rid, {}).get("tokens", ())) >= KILL_AFTER_TOKENS,
                f"{tag}: decode progress before the kill")
    victim.bus.dead = True
    engine.cancel(rid)
    await bus.flush()   # frames published before the kill reach the stand-in
    delivered = len(job.text)
    snap = standin.snapshots[rid]
    survivor = WorkerService(bus, {WORKER_MODEL: engine},
                             WorkerConfig(worker_id=f"{WORKER_ID}-{tag}-2",
                                          heartbeat_interval_ms=1000), stream_flush_ms=20)
    await survivor.start()
    workers.append(survivor)
    resume = {"tokens": snap["tokens"], "seed": snap["seed"], "sentChars": delivered}
    await standin.submit(survivor.worker_id, _worker_request(rid, n, prompt, resume=resume),
                         job=job)
    res = await asyncio.wait_for(job.result, 600)
    check(res.success, f"worker {tag}: resumed run failed: {res.error}")
    return {"undisturbed": ref_res, "undisturbed_text": ref.text, "resumed": res,
            "resumed_text": job.text, "snapshot_tokens": len(snap["tokens"]),
            "delivered_chars_at_kill": delivered}


def _worker_wave(rng) -> tuple[list, list]:
    """The worker phase's seven streams, generate and chat: a prompt longer
    than one chunk (1,500 byte tokens > 1,024: mixed admission), the rest a
    few hundred tokens. (prompts, requests)."""
    prompts = [_prompt(rng, n) for n in (300, 450, 200, 600, 350, 500, 1500)]
    wave = [_worker_request(f"w{i}", n, prompt=p)
            for i, (p, n) in enumerate(zip(prompts[:4], (96, 64, 80, 72)))]
    wave += [_worker_request(f"c{i}", n, messages=[{"role": "user", "content": p}])
             for i, (p, n) in enumerate(zip(prompts[4:6], (64, 96)))]
    wave.append(_worker_request("long", 64, prompt=prompts[6]))
    return prompts, wave


async def _worker_prewarmed(engine) -> dict:
    """The seven streams through a WorkerService on an engine that
    prewarmed at construction, with no warm-up job: TTFT and output
    tokens/s as the stand-in sees them (a reading beside the warmed-up
    run's)."""
    import asyncio
    import random

    from gridllm_torch.bus import InMemoryBus
    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker.service import WorkerService

    bus = InMemoryBus()
    await bus.connect()
    standin = _StandIn(bus)
    await standin.start()
    worker = WorkerService(bus, {WORKER_MODEL: engine},
                           WorkerConfig(worker_id=f"{WORKER_ID}-prewarm",
                                        heartbeat_interval_ms=1000), stream_flush_ms=20)
    await worker.start()
    try:
        _, wave = _worker_wave(random.Random(SEED + 7))
        t0 = time.perf_counter()
        jobs = [await standin.submit(worker.worker_id, req) for req in wave]
        served = [await asyncio.wait_for(j.result, 600) for j in jobs]
        wall = time.perf_counter() - t0
    finally:
        await worker.stop(announce=False)
        await bus.disconnect()
    for job, res in zip(jobs, served):
        check(res.success and job.t_first is not None,
              f"worker prewarm: job {job.req.id} {res.error or 'streamed nothing'}")
    ttft = [(j.t_first - j.t_submit) * 1e3 for j in jobs]
    tokens = sum(r.response.eval_count for r in served)
    return {"jobs": len(jobs), "ttft_ms_p50": statistics.median(ttft), "ttft_ms": ttft,
            "output_tokens": tokens, "wall_s": wall, "output_tokens_per_s": tokens / wall}


async def _worker_serve(torch, engine) -> dict:
    import asyncio
    import random

    from gridllm_torch.bus import InMemoryBus
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker import service as wsvc
    from gridllm_torch.worker.service import WorkerService

    results = _capture_results(engine)
    bus = InMemoryBus()
    await bus.connect()
    standin = _StandIn(bus)
    await standin.start()
    worker = WorkerService(_DeadableBus(bus), {WORKER_MODEL: engine},
                           WorkerConfig(worker_id=WORKER_ID, heartbeat_interval_ms=1000),
                           stream_flush_ms=20)
    await worker.start()
    workers = [worker]
    rng = random.Random(SEED + 7)
    try:
        # eight concurrent streams, generate and chat: a prompt longer than
        # one chunk (1,500 byte tokens > 1,024: mixed admission), the rest a
        # few hundred tokens; one long job is cancelled mid-stream
        prompts, wave = _worker_wave(rng)
        wave.append(_worker_request("cancel", 400, prompt=_prompt(rng, 250)))
        # warm-up, not measured: the first model calls of the process pay
        # one-time costs (library handles, first launches of each shape)
        for i, n in enumerate((300, 1500)):
            warm = await standin.submit(WORKER_ID, _worker_request(f"warm{i}", 8,
                                                                   prompt=_prompt(rng, n)))
            res = await asyncio.wait_for(warm.result, 600)
            check(res.success, f"worker: warm-up {res.error}")
        ck.reset_launch_counts()
        with _PlainWatch(torch) as plain:
            t0 = time.perf_counter()
            jobs = [await standin.submit(WORKER_ID, req) for req in wave]
            # the ninth assignment finds every slot taken: NACKed
            await _wait(lambda: worker.current_jobs == worker.max_concurrent,
                        "eight jobs executing")
            over = await standin.submit(WORKER_ID, _worker_request("over", 16, prompt="x"))
            nack = await asyncio.wait_for(over.result, 60)
            check(not nack.success and nack.nack and "capacity" in (nack.error or ""),
                  f"worker: the ninth job was not NACKed: {nack.model_dump()}")
            cancel_job = jobs[-1]
            await _wait(lambda: cancel_job.frames >= 3, "the cancel job's stream")
            await standin.cancel(WORKER_ID, "cancel")
            await _wait(lambda: "cancel" in results, "the cancelled generation")
            check(results["cancel"].done_reason == "cancel",
                  f"worker: cancel ended {results['cancel'].done_reason!r}")
            served = [await asyncio.wait_for(j.result, 600) for j in jobs[:-1]]
            wall = time.perf_counter() - t0
            await _wait(lambda: worker.current_jobs == 0, "the cancelled job's end")
            check(not cancel_job.result.done(), "worker: the cancelled job published a result")
            for job, res in zip(jobs, served):
                n = job.req.options["num_predict"]
                ev = res.response.eval_count if res.success else None
                check(res.success and (ev == n or (res.response.done_reason == "stop" and ev < n)),
                      f"worker: job {job.req.id} {res.error or ''} ({ev} of {n} tokens)")
                check(job.text == _final_text(res),
                      f"worker: job {job.req.id} stream differs from its final text")
            check(results["long"].prompt_eval_count > engine._chunk_len,
                  "worker: the long prompt fit in one chunk")
            # a repeat of a generate and of a chat prompt: prefix cache hits
            repeats = [await standin.submit(WORKER_ID, _worker_request("w0-again", 16,
                                                                       prompt=prompts[0])),
                       await standin.submit(WORKER_ID, _worker_request(
                           "c0-again", 16, messages=[{"role": "user", "content": prompts[4]}]))]
            for job in repeats:
                res = await asyncio.wait_for(job.result, 600)
                check(res.success and results[job.req.id].cached_tokens > 0,
                      f"worker: repeat {job.req.id} missed the prefix cache")
            launches = ck.launch_counts()
            bf16_resume = await _kill_and_resume(bus, standin, engine, workers, "bf16",
                                                 _prompt(rng, 400), 96)
        check(not any(plain.counts.values()),
              f"worker: a plain version ran on the card: {plain.counts}")
        for name in ("flash_prefill", "ragged_attention", "paged_write_decode",
                     "paged_write_chunk"):
            check(launches[name] > 0, f"worker: {name} never launched: {launches}")
        ttft = [(j.t_first - j.t_submit) * 1e3 for j in jobs[:-1]]
        tokens = sum(r.response.eval_count for r in served)
        u, r = bf16_resume["undisturbed"], bf16_resume["resumed"]
        same = 0
        for a, b in zip(bf16_resume["resumed_text"], bf16_resume["undisturbed_text"]):
            if a != b:
                break
            same += 1
        return {
            "jobs": len(served), "nacked": 1, "cancelled": 1,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms": ttft,
            "output_tokens": tokens, "wall_s": wall, "output_tokens_per_s": tokens / wall,
            "long_prompt_tokens": results["long"].prompt_eval_count,
            "repeat_cached_tokens": [results[j.req.id].cached_tokens for j in repeats],
            "jobs_total": {e: wsvc._JOBS_TOTAL.value(event=e)
                           for e in ("completed", "nacked", "cancelled")},
            "launches": launches, "plain_calls_on_card": plain.counts,
            # bf16, a reading: the resumed admission computes the rows after
            # its last cached page in a chunk, not in the decode steps that
            # made them, so bf16 rounding can depart from the undisturbed
            # stream (as the serve phase's warm repeats do); byte identity
            # is held in float32 below, as the replay phase holds warm ==
            # cold
            "bf16_resume": {
                "snapshot_tokens": bf16_resume["snapshot_tokens"],
                "delivered_chars_at_kill": bf16_resume["delivered_chars_at_kill"],
                "equals_undisturbed": bf16_resume["resumed_text"] ==
                bf16_resume["undisturbed_text"],
                "stream_is_final_text": bf16_resume["resumed_text"] == _final_text(r),
                "chars_matching": f"{same}/{len(bf16_resume['undisturbed_text'])}",
                "eval_counts": [u.response.eval_count, r.response.eval_count]},
        }
    finally:
        for w in reversed(workers):
            await w.stop(announce=False)
        await bus.disconnect()


async def _worker_resume_f32(engine) -> dict:
    from gridllm_torch.bus import InMemoryBus
    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker.service import WorkerService

    import random

    bus = InMemoryBus()
    await bus.connect()
    standin = _StandIn(bus)
    await standin.start()
    worker = WorkerService(_DeadableBus(bus), {WORKER_MODEL: engine},
                           WorkerConfig(worker_id=f"{WORKER_ID}-f32",
                                        heartbeat_interval_ms=1000), stream_flush_ms=20)
    await worker.start()
    workers = [worker]
    try:
        out = await _kill_and_resume(bus, standin, engine, workers, "f32",
                                     _prompt(random.Random(SEED + 8), 400), 96)
    finally:
        for w in reversed(workers):
            await w.stop(announce=False)
        await bus.disconnect()
    u, r = out["undisturbed"], out["resumed"]
    check(out["resumed_text"] == _final_text(r),
          "worker: the float32 resumed stream is not its final text")
    check(out["resumed_text"] == out["undisturbed_text"],
          "worker: the float32 resumed stream differs from the undisturbed run")
    check(r.response.eval_count == u.response.eval_count,
          f"worker: eval_count {r.response.eval_count} after the resume, "
          f"{u.response.eval_count} undisturbed")
    return {"snapshot_tokens": out["snapshot_tokens"],
            "delivered_chars_at_kill": out["delivered_chars_at_kill"],
            "eval_count": r.response.eval_count, "equals_undisturbed": True,
            "resumed_by": r.workerId}


def _printable_head(torch, engine) -> None:
    """Zero the output columns of every id the byte tokenizer does not print
    as one ASCII character (bytes 128-255, BOS, EOS and the ids past them):
    greedy then picks ASCII bytes, so each token streams a character, as a
    trained model's text does. With all 128,256 columns random, almost
    every token is an id past the bytes that decodes to nothing, and the
    streams the worker publishes would be empty. A rank of a tensor-parallel
    engine holds its slice of the columns, in rank order. A tied head
    (gemma2) zeroes those embedding rows; an embedding model is left as
    it is."""
    if engine.embedding_only:
        return
    model = engine.model
    with torch.no_grad():
        if model.lm_head is None:   # a tied head: the embedding rows are its columns
            rows = model.embed
            lo = 0 if rows.shape[0] == engine.cfg.vocab_size else \
                engine.mesh.axis_rank("tp") * rows.shape[0]
            rows[max(128 - lo, 0):] = 0
            return
        head = model.lm_head
        lo = 0
        if head.shape[1] != engine.cfg.vocab_size:   # a vocab-split head
            lo = engine.mesh.axis_rank("tp") * head.shape[1]
        head[:, max(128 - lo, 0):] = 0


def phase_worker(torch) -> dict:
    """llama3:8b bf16 with the engine's defaults behind the port's
    WorkerService on the port's InMemoryBus, a stand-in scheduler on the
    other side: eight concurrent generate and chat streams (one prompt
    longer than a chunk), a ninth assignment NACKed, a cancel mid-stream,
    prefix-cache repeats, and a worker killed mid-decode whose job resumes
    on a second WorkerService from its last snapshot; the same kill in
    float32, where the resumed stream must equal the undisturbed one byte
    for byte. The launch counters are 0 before the main path and read
    after it; no plain version runs on the card."""
    import asyncio
    import os

    from gridllm_torch.engine import EngineConfig, InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(model=WORKER_MODEL), device="cuda")
    _printable_head(torch, engine)
    out = asyncio.run(_worker_serve(torch, engine))
    check(not engine.running, "worker: the engine's runner did not stop")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(model=WORKER_MODEL, dtype="float32"), device="cuda")
    _printable_head(torch, engine)
    out["f32_resume"] = asyncio.run(_worker_resume_f32(engine))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["GRIDLLM_PREWARM_COMPILES"] = "1"
    try:
        engine = InferenceEngine(EngineConfig(model=WORKER_MODEL), device="cuda")
    finally:
        del os.environ["GRIDLLM_PREWARM_COMPILES"]
    check(engine.prewarm_duration_ns > 0, "worker: the engine did not prewarm")
    _printable_head(torch, engine)
    out["prewarm_no_warmup"] = {"prewarm_ms": engine.prewarm_duration_ns / 1e6,
                                **asyncio.run(_worker_prewarmed(engine))}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "worker", "model": WORKER_MODEL, "dtype": "bfloat16",
            "device": torch.cuda.get_device_name(0), "card": card_line(), **out}


# ---------------------------------------------------------------------------
# sched: the port's scheduler over port workers on the card
# ---------------------------------------------------------------------------

SCHED_WORKERS = ("sched-a", "sched-b")
SCHED_SLOTS = 6            # per worker: 12 slots in all, so 4 of the 16 jobs queue
SCHED_DRAIN_TOKENS = 160   # long enough that the drain lands mid-decode
SCHED_DRAIN_AFTER = 16     # snapshot tokens before the drain


def _prefix_key(model: str, prompt: str) -> str:
    """The gateway's prefix-affinity key of a generate request (the hash of
    the model and the prompt's first KiB), which the gateway stamps as
    metadata.prefixKey."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    h.update(model.encode())
    h.update(b"\x1f")
    h.update(prompt[:1024].encode())
    return h.hexdigest()


def _sched_request(rid, n, prompt=None, messages=None, stream=True):
    req = _worker_request(rid, n, prompt=prompt, messages=messages)
    req.stream = stream
    if prompt is not None:
        req.metadata["prefixKey"] = _prefix_key(WORKER_MODEL, prompt)
    return req


class _SchedStack:
    """The port's WorkerRegistry and JobScheduler on the port's InMemoryBus
    with port WorkerServices, each on its own engine behind a _DeadableBus."""

    def __init__(self, config):
        self.config = config
        self.workers: dict = {}

    async def __aenter__(self):
        from gridllm_torch.bus import InMemoryBus
        from gridllm_torch.scheduler import JobScheduler, WorkerRegistry

        self.bus = InMemoryBus()
        await self.bus.connect()
        self.registry = WorkerRegistry(self.bus, self.config)
        self.scheduler = JobScheduler(self.bus, self.registry, self.config)
        await self.registry.initialize()
        await self.scheduler.initialize()
        return self

    async def add(self, wid, engine, heartbeat_ms=300):
        from gridllm_torch.utils.config import WorkerConfig
        from gridllm_torch.worker.service import WorkerService

        svc = WorkerService(_DeadableBus(self.bus), {WORKER_MODEL: engine},
                            WorkerConfig(worker_id=wid, heartbeat_interval_ms=heartbeat_ms),
                            stream_flush_ms=20)
        await svc.start()
        self.workers[wid] = svc
        await _wait(lambda: self.registry.get_worker(wid) is not None, f"sched: {wid} registered")
        return svc

    async def __aexit__(self, *exc):
        for svc in self.workers.values():
            await svc.stop(announce=False)
        await self.scheduler.shutdown()
        await self.registry.shutdown()
        await self.bus.disconnect()

    async def run(self, req):
        """One job through submit_streaming_job (stream) or submit_and_wait:
        (result or the exception, the text its chunks put together)."""
        chunks: list[str] = []

        async def on_chunk(c):
            chunks.append(c.response or (c.message or {}).get("content", ""))

        try:
            if req.stream:
                res = await self.scheduler.submit_streaming_job(req, on_chunk, timeout_ms=600_000)
            else:
                res = await self.scheduler.submit_and_wait(req, timeout_ms=600_000)
        except Exception as e:  # noqa: BLE001 — the caller checks what it expects
            res = e
        return res, "".join(chunks)

    def spans(self, job_id) -> dict:
        """The scheduler's trace of a job, by span name: the first span of
        each name."""
        out: dict = {}
        for s in self.scheduler.tracer.export(job_id) or []:
            out.setdefault(s["name"], s)
        return out

    def queue_wait_ms(self, job_id) -> float:
        spans = self.scheduler.tracer.export(job_id) or []
        return sum((s["end"] - s["start"]) * 1e3 for s in spans
                   if s["name"] == "queue.wait" and s.get("end") is not None)

    def host_ms(self, job_id) -> float:
        """The scheduler's own host time for a job: from its submit (the
        gateway.request span's start) to its first assignment's publish
        (the scheduler.dispatch event)."""
        sp = self.spans(job_id)
        return (sp["scheduler.dispatch"]["start"] - sp["gateway.request"]["start"]) * 1e3

    def ttft_ms(self, job_id) -> float:
        """Submit to the first chunk, as the scheduler's stream handler
        stamps it (the gateway.first_token event)."""
        return float(self.spans(job_id)["gateway.first_token"]["meta"]["ttftMs"])


def _pct(xs, q) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


async def _sched_serve(torch, engines) -> dict:
    """The bf16 part: warm-up, then with the launch counters from 0 the
    16-job wave (one cancelled mid-stream), two prefix-affinity repeats and
    a drain mid-decode; the usage ledger, the SLO and health views."""
    import asyncio
    import os
    import random

    from gridllm_torch.obs.usage import engine_usage_totals
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.utils.config import SchedulerConfig

    results = {wid: _capture_results(e) for wid, e in zip(SCHED_WORKERS, engines)}
    rng = random.Random(SEED + 17)
    usage0 = engine_usage_totals()
    async with _SchedStack(SchedulerConfig(sweep_interval_ms=200)) as st:
        for wid, engine in zip(SCHED_WORKERS, engines):
            await st.add(wid, engine)
        # warm-up, not measured: one short and one chunked prompt per worker
        warm = [_sched_request(f"warm{i}", 8, prompt=_prompt(rng, n))
                for i, n in enumerate((300, 1500, 320, 1480))]
        for req in warm:
            res, _ = await st.run(req)
            check(not isinstance(res, Exception) and res.success, f"sched: warm-up {res!r}")
        prompts = [_prompt(rng, n) for n in
                   (300, 450, 200, 600, 350, 500, 250, 400, 1500, 320, 280, 380, 420, 360)]
        wave = [_sched_request(f"g{i}", n, prompt=p) for i, (p, n) in
                enumerate(zip(prompts[:9], (64, 48, 56, 64, 48, 64, 56, 48, 48)))]
        wave.append(_sched_request("cancel", 400, prompt=prompts[9]))
        wave += [_sched_request(f"c{i}", n, messages=[{"role": "user", "content": p}])
                 for i, (p, n) in enumerate(zip(prompts[10:13], (64, 48, 56)))]
        wave += [_sched_request("b0", 48, prompt=prompts[13], stream=False),
                 _sched_request("b1", 56, prompt=_prompt(rng, 330), stream=False),
                 _sched_request("b2", 48, messages=[{"role": "user", "content": _prompt(rng, 300)}],
                                stream=False)]
        check(len(wave) == 16, "sched: the wave is 16 jobs")
        depth: list[int] = []
        ck.reset_launch_counts()
        with _PlainWatch(torch) as plain:
            t0 = time.perf_counter()

            async def watch_queue():
                while True:
                    depth.append(st.scheduler.get_stats()["queuedJobs"])
                    await asyncio.sleep(0.005)

            watcher = asyncio.create_task(watch_queue())
            tasks = {req.id: asyncio.create_task(st.run(req)) for req in wave}
            # the cancel once the queue has drained, so the slot it frees
            # is not offered to a queued job while the worker still runs
            # the cancelled generation (that assignment would be NACKed)
            await _wait(lambda: st.scheduler.get_stats()["queuedJobs"] == 0 and len(
                st.scheduler._resume_snap.get("cancel", {}).get("tokens", ())) >= 8,
                "sched: the queue drained and the cancel job decoding")
            check(await st.scheduler.cancel_job("cancel"), "sched: cancel_job refused")
            # the client goes away, as the gateway's does on a cancel
            tasks.pop("cancel").cancel()
            done = {rid: await t for rid, t in tasks.items()}
            wall = time.perf_counter() - t0
            watcher.cancel()
            await _wait(lambda: any(r.get("cancel") is not None for r in results.values()),
                        "sched: the cancelled generation's end")
            check(all(r["cancel"].done_reason == "cancel" for r in results.values()
                      if "cancel" in r), "sched: the cancelled generation was not cancelled")
            served_by: dict[str, str] = {}
            for req in wave:
                if req.id == "cancel":
                    continue
                res, text = done[req.id]
                check(not isinstance(res, Exception) and res.success,
                      f"sched: job {req.id} failed: {res!r}")
                n, ev = req.options["num_predict"], res.response.eval_count
                check(ev == n or (res.response.done_reason == "stop" and ev < n),
                      f"sched: job {req.id} {ev} of {n} tokens")
                if req.stream:
                    check(text == _final_text(res), f"sched: job {req.id} stream != final text")
                served_by[req.id] = res.workerId
            check(set(served_by.values()) == set(SCHED_WORKERS),
                  f"sched: the wave did not spread over both workers: {served_by}")
            check(max(depth) > 0, "sched: no job waited in the scheduler's queue")
            check(any(results[w].get("g8") is not None and
                      results[w]["g8"].prompt_eval_count > engines[0]._chunk_len
                      for w in SCHED_WORKERS), "sched: the long prompt fit in one chunk")
            # prefix affinity: a prompt served by each worker, repeated, lands
            # on the worker whose heartbeat digest holds its prefix key
            affinity = {}
            for wid in SCHED_WORKERS:
                rid = next(r.id for r in wave if served_by.get(r.id) == wid and r.prompt
                           and r.stream)
                req0 = next(r for r in wave if r.id == rid)
                key = req0.metadata["prefixKey"]
                await _wait(lambda: key in st.registry.get_worker(wid).cachedPrefixes,
                            f"sched: {wid}'s digest")
                res, _ = await st.run(_sched_request(f"{rid}-again", 16, prompt=req0.prompt))
                check(not isinstance(res, Exception) and res.success and res.workerId == wid,
                      f"sched: the repeat of {rid} went to {getattr(res, 'workerId', res)}")
                cached = results[wid][f"{rid}-again"].cached_tokens
                check(cached > 0, f"sched: the repeat of {rid} missed the prefix cache")
                affinity[rid] = {"worker": wid, "cached_tokens": cached}
            # drain the worker that holds a long job mid-decode
            os.environ["GRIDLLM_KVX_TIMEOUT_MS"] = "120000"
            try:
                req = _sched_request("drain", SCHED_DRAIN_TOKENS, prompt=_prompt(rng, 400))
                task = asyncio.create_task(st.run(req))
                await _wait(lambda: len(st.scheduler._resume_snap.get("drain", {}).get(
                    "tokens", ())) >= SCHED_DRAIN_AFTER, "sched: decode before the drain")
                victim = st.scheduler.active_jobs["drain"].workerId
                snap_tokens = len(st.scheduler._resume_snap["drain"]["tokens"])
                report = await st.workers[victim].drain(budget_ms=0)
                res, text = await task
            finally:
                del os.environ["GRIDLLM_KVX_TIMEOUT_MS"]
            check(report.get("suspended") == 1, f"sched: drain report {report}")
            check(not isinstance(res, Exception) and res.success and res.workerId != victim,
                  f"sched: the drained job {res!r}")
            check(text == _final_text(res), "sched: the drained stream is not exactly once")
            handoff = {e: st.scheduler._resume_total.value(event=e)
                       for e in ("drain_handoff", "drain_requeued", "stamped")}
            check(handoff["drain_handoff"] + handoff["drain_requeued"] >= 1,
                  f"sched: the scheduler took no drain handoff: {handoff}")
            launches = ck.launch_counts()
        check(not any(plain.counts.values()), f"sched: a plain version ran on the card: "
                                              f"{plain.counts}")
        for name in ("flash_prefill", "ragged_attention", "ragged_attention.chunk",
                     "ragged_attention.group", "paged_write_decode", "paged_write_chunk"):
            check(launches[name] > 0, f"sched: {name} never launched: {launches}")
        # the usage ledger: the engine half (process-global) grew by what the
        # scheduler's half accounted
        await st.bus.flush()
        usage1 = engine_usage_totals()
        engine_half = {k: usage1.get(k, 0.0) - usage0.get(k, 0.0) for k in usage1}
        engine_half = {k: v for k, v in engine_half.items() if v}
        sched_half = st.scheduler.usage.token_totals()
        check(engine_half == sched_half,
              f"sched: usage ledger {sched_half} != the engines' {engine_half}")
        health = {wid: (st.scheduler.health.state_of(wid),
                        st.registry.get_worker(wid).healthState) for wid in SCHED_WORKERS}
        check(all(h == ("online", "online") for h in health.values()),
              f"sched: health {health}")
        slo = st.scheduler.slo.snapshot()
        judged = sum(c["requests"] for c in slo["classes"].values())
        # the readings a client of the scheduler sees
        streamed = [r for r in wave if r.stream and r.id != "cancel"]
        ttft = [st.ttft_ms(r.id) for r in streamed]
        tokens = sum(done[r.id][0].response.eval_count for r in wave if r.id != "cancel")
        waits = [st.queue_wait_ms(r.id) for r in wave if r.id != "cancel"]
        # the scheduler's own host time, submit to the assignment's publish,
        # of the jobs placed at once (the first 12 dispatched, one a slot)
        placed = sorted(wave, key=lambda r: st.spans(r.id)["scheduler.dispatch"]["start"])
        host = [st.host_ms(r.id) for r in placed[:2 * SCHED_SLOTS]]
        return {
            "jobs": len(wave), "cancelled": 1, "served_by": served_by,
            "cancelled_jobs": st.scheduler.get_stats()["totalJobsCancelled"],
            "max_queue_depth": max(depth),
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p90": _pct(ttft, 0.9), "ttft_ms": ttft,
            "output_tokens": tokens, "wall_s": wall, "output_tokens_per_s": tokens / wall,
            "queue_wait_ms_p50": _pct(waits, 0.5), "queue_wait_ms_max": max(waits),
            "sched_host_ms_p50": _pct(host, 0.5), "sched_host_ms_p90": _pct(host, 0.9),
            "sched_host_ms_max": max(host), "sched_host_jobs": len(host),
            "affinity": affinity,
            "drain": {"victim": victim, "served_by": res.workerId, **handoff,
                      "snapshot_tokens_at_drain": snap_tokens},
            "usage_tokens": sched_half, "slo_judged": judged,
            "slo_attainment": {k: c["attainment"] for k, c in slo["classes"].items()},
            "health": {k: v[0] for k, v in health.items()},
            "stats": {k: v for k, v in st.scheduler.get_stats().items() if k != "shard"},
            "launches": launches, "plain_calls_on_card": plain.counts,
        }


async def _sched_kill(torch, engines, prompt) -> dict:
    """The float32 cut: an undisturbed job on the victim alone, then the
    same job again, the victim killed (its bus silenced and its generation
    dropped, as the killed process's) once the scheduler holds
    KILL_AFTER_TOKENS snapshot tokens, after a survivor joined. The port's
    registry must evict the victim and the port's scheduler requeue the job
    with its watermark; the survivor finishes it exactly once, its stream
    byte-identical to the undisturbed one."""
    import asyncio

    from gridllm_torch.utils.config import SchedulerConfig

    config = SchedulerConfig(worker_heartbeat_timeout_ms=1500, worker_cleanup_interval_ms=200,
                             connection_monitor_interval_ms=200, quick_disconnect_window_ms=1500,
                             orphan_assign_threshold_ms=1000, retry_delay_ms=100,
                             sweep_interval_ms=200)
    survivor_results = _capture_results(engines[1])
    async with _SchedStack(config) as st:
        victim = await st.add("victim", engines[0], heartbeat_ms=200)
        ref, ref_text = await st.run(_sched_request("f32-ref", 96, prompt=prompt))
        check(not isinstance(ref, Exception) and ref.success and ref_text == _final_text(ref),
              f"sched f32: undisturbed run {ref!r}")
        task = asyncio.create_task(st.run(_sched_request("f32-kill", 96, prompt=prompt)))
        await _wait(lambda: len(st.scheduler._resume_snap.get("f32-kill", {}).get("tokens", ()))
                    >= KILL_AFTER_TOKENS, "sched f32: decode progress before the kill")
        await st.add("survivor", engines[1], heartbeat_ms=200)
        victim.bus.dead = True
        engines[0].cancel("f32-kill")
        res, text = await task
        check(not isinstance(res, Exception) and res.success, f"sched f32: resumed run {res!r}")
        evicted = st.registry.get_worker("victim") is None
        orphaned = st.scheduler._jobs_total.value(event="orphaned")
        stamped = st.scheduler._resume_total.value(event="stamped")
        completed = st.scheduler.total_completed
    check(res.workerId == "survivor" and evicted, f"sched f32: served by {res.workerId}, "
                                                  f"victim evicted {evicted}")
    check(orphaned >= 1 and stamped >= 1, f"sched f32: orphaned {orphaned}, stamped {stamped}")
    check(text == _final_text(res) == ref_text,
          "sched f32: the resumed stream differs from the undisturbed run")
    check(res.response.eval_count == ref.response.eval_count and completed == 2,
          f"sched f32: eval_count {res.response.eval_count} of {ref.response.eval_count}, "
          f"{completed} completions")
    check("f32-kill" in survivor_results, "sched f32: the survivor never served the job")
    return {"resumed_by": res.workerId, "victim_evicted": evicted, "orphaned": orphaned,
            "stamped": stamped, "equals_undisturbed": True, "eval_count": res.response.eval_count,
            "resume_cached_tokens": survivor_results["f32-kill"].cached_tokens}


def phase_sched(torch) -> dict:
    """The port's scheduler (registry, JobScheduler, placement, SLO,
    health, usage ledger) on the port's InMemoryBus over two port
    WorkerServices, each llama3:8b bf16 on the card with the engine's
    defaults and SCHED_SLOTS slots: 16 concurrent generate and chat jobs
    through submit_streaming_job and submit_and_wait (one prompt longer
    than a chunk; those past the 12 advertised slots wait in the
    scheduler's queue), one cancelled mid-stream through cancel_job,
    prefix-affinity repeats, a drain mid-decode the scheduler hands off;
    launch counters from 0 over that path, no plain version on the card,
    the usage ledger's two halves equal, both workers healthy. Then a
    worker killed mid-decode on the 8-layer float32 cut, evicted by the
    registry and its job resumed by the scheduler on the survivor,
    byte-identical to the undisturbed run. Reads from the scheduler's own
    trace TTFT (submit to the first chunk), the queue wait (its queue
    spans) and its host time (submit to the assignment's publish); output
    tokens/s."""
    import asyncio
    import random

    engines = [_kvx_engine(torch, max_slots=SCHED_SLOTS) for _ in SCHED_WORKERS]
    out = asyncio.run(_sched_serve(torch, engines))
    check(not any(e.running for e in engines), "sched: an engine's runner did not stop")
    del engines
    f32 = [_kvx_engine(torch, model=_kvx_f32_model(), dtype="float32") for _ in range(2)]
    with _PlainWatch(torch) as plain:
        out["kill_f32"] = asyncio.run(_sched_kill(torch, f32,
                                                  _prompt(random.Random(SEED + 18), 400)))
    check(not any(plain.counts.values()), f"sched f32: a plain version ran: {plain.counts}")
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "sched", "model": WORKER_MODEL, "dtype": "bfloat16",
            "slots_per_worker": SCHED_SLOTS, "card": card_line(), **out}


def _replay_rounding(torch) -> dict:
    """bf16, one operation at a time: (a) a prompt's uncached rows as the
    warm replay computes them (ragged chunk region, 1032-row mixed-step
    product) and as the cold run does (flash_prefill, 1024-row bucket);
    prompt of 301 tokens, 256 of them cached (4 pages). (b) a decoding
    slot's rows in an 8-row decode-step product and at the tail of a
    mixed step's 1032-row product, as when another request's chunk is
    admitted beside it."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.layers import rms_norm

    inp = Inputs(torch, SEED + 2)
    bf16, t, n, cached = torch.bfloat16, 1024, 301, 256
    fresh = n - cached
    q = inp.randn(1, t, H, D, dtype=bf16)
    k, v = inp.randn(1, t, KVH, D, dtype=bf16), inp.randn(1, t, KVH, D, dtype=bf16)
    sl = torch.tensor([n], dtype=torch.int32, device="cuda")
    cold = ck.flash_prefill(q, k, v, sl)[0, cached:n]
    pages = cached // PS
    kp = k[:, :cached].reshape(1, pages, PS, KVH, D).contiguous()
    vp = v[:, :cached].reshape(1, pages, PS, KVH, D).contiguous()

    def chunk(x):  # the prompt's uncached rows at the head of a 1024-row chunk
        out = torch.zeros((t,) + tuple(x.shape[2:]), dtype=bf16, device="cuda")
        out[:fresh] = x[0, cached:n]
        return out

    table = torch.arange(pages, dtype=torch.int32, device="cuda")
    chunk_kw = dict(q_chunk=chunk(q)[None], chunk_row=table, chunk_start=cached,
                    chunk_total=n, k_chunk=chunk(k), v_chunk=chunk(v))
    warm, _ = ck.ragged_attention(kp, vp, PS, **chunk_kw, layer=0)
    prompt_rows = {"attention": _max_err(warm[0, :fresh], cold)}
    # a decode step's group region alone, and beside a chunk in one launch
    group_kw = dict(q_group=inp.randn(S, 1, H, D, dtype=bf16),
                    page_table=table.repeat(S, 1),
                    group_lengths=torch.randint(1, cached + 1, (S,), generator=inp.gen,
                                                device="cuda", dtype=torch.int32),
                    k_group=inp.randn(S, 1, KVH, D, dtype=bf16),
                    v_group=inp.randn(S, 1, KVH, D, dtype=bf16))
    _, alone = ck.ragged_attention(kp, vp, PS, **group_kw, layer=0)
    _, beside = ck.ragged_attention(kp, vp, PS, **chunk_kw, **group_kw, layer=0)
    decode_rows = {"attention": _max_err(alone, beside)}
    for name, e, f in (("wq", 4096, H * D), ("w_gate", 4096, 14336), ("w_down", 14336, 4096)):
        x = inp.randn(t, e, dtype=bf16)
        xd = inp.randn(S, e, dtype=bf16)
        xm = torch.zeros((t + S, e), dtype=bf16, device="cuda")
        xm[:fresh] = x[cached:n]
        xm[t:] = xd
        w = (inp.randn(e, f, dtype=torch.float32) * e ** -0.5).to(bf16)
        mixed = xm @ w
        prompt_rows[f"projection_{name}"] = _max_err(mixed[:fresh], (x @ w)[cached:n])
        decode_rows[f"projection_{name}"] = _max_err(mixed[t:], xd @ w)
        if name == "wq":  # the norm before it: decode_step's [S, 1, E] rows
            ones = torch.ones(e, dtype=bf16, device="cuda")
            prompt_rows["rms_norm"] = _max_err(rms_norm(xm[None], ones)[0, :fresh],
                                               rms_norm(x[None], ones)[0, cached:n])
            decode_rows["rms_norm"] = _max_err(rms_norm(xm[None], ones)[0, t:],
                                               rms_norm(xd[:, None], ones)[:, 0])
    torch.cuda.synchronize()
    return {"prompt_rows": fresh, "prompt_max_abs_diff": prompt_rows,
            "decode_rows": S, "decode_max_abs_diff": decode_rows}


def phase_replay(torch) -> dict:
    """Warm prefix-cache replay against the cold run, in float32."""
    import random

    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine

    gc.collect()   # the serve phase's bf16 engine
    torch.cuda.empty_cache()
    prompt = _prompt(random.Random(SEED), 300)
    engine = InferenceEngine(EngineConfig(model="llama3:8b", dtype="float32",
                                          spec_decode=False), device="cuda")
    engine.start()
    try:
        runs = [engine.generate(GenerationRequest(
            id=f"f32-{i}", prompt=prompt, options={"temperature": 0.0, "num_predict": 64}))
            for i in range(2)]
    finally:
        engine.stop()
    cold, warm = runs
    for res in runs:
        check(res.done_reason in ("length", "stop") and res.token_ids,
              f"replay: {res.id} finished {res.done_reason!r} ({res.error})")
    check(cold.cached_tokens == 0 and warm.cached_tokens > 0,
          f"replay: cached tokens {cold.cached_tokens}, {warm.cached_tokens}")
    check(warm.token_ids == cold.token_ids, "replay: float32 warm stream differs from cold")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "replay", "model": "llama3:8b", "dtype": "float32",
            "cached_tokens": warm.cached_tokens, "tokens": len(warm.token_ids),
            "warm_equals_cold": True, "bf16_cold_vs_warm": _replay_rounding(torch)}


def phase_spec(torch) -> dict:
    """Greedy parity in float32: a repetitive prompt whose drafts get
    accepted gives the same stream with speculative decoding on and off,
    with ragged attention on and off (four engines, one after the other)."""
    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine

    prompt = "the cat sat on the mat and the dog sat on the log. " * 6
    opts = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 64}
    runs = {}
    for spec in (True, False):
        for ragged in (True, False):
            gc.collect()
            torch.cuda.empty_cache()
            engine = InferenceEngine(EngineConfig(model="llama3:8b", dtype="float32",
                                                  spec_decode=spec, ragged_attention=ragged),
                                     device="cuda")
            res = engine.generate(GenerationRequest(id="spec", prompt=prompt,
                                                    options=dict(opts)))
            check(res.done_reason in ("length", "stop") and res.token_ids,
                  f"spec: finished {res.done_reason!r} ({res.error})")
            name = f"spec_{'on' if spec else 'off'}_ragged_{'on' if ragged else 'off'}"
            runs[name] = {"tokens": res.token_ids, "proposed": res.spec_proposed,
                          "accepted": res.spec_accepted,
                          "verify_steps": engine.spec_stats["steps"]}
            del engine
    gc.collect()
    torch.cuda.empty_cache()
    streams = {name: r.pop("tokens") for name, r in runs.items()}
    ref = streams["spec_off_ragged_on"]
    same = {name: toks == ref for name, toks in streams.items()}
    check(all(same.values()), f"spec: greedy streams differ: {same}")
    for name, r in runs.items():
        check(r["accepted"] > 0 or name.startswith("spec_off"),
              f"spec: {name} accepted no draft")
    return {"phase": "spec", "model": "llama3:8b", "dtype": "float32",
            "tokens": len(ref), "streams_identical": True, "runs": runs}


# ---------------------------------------------------------------------------
# checkpoint: serving from safetensors, the weight snapshot tier, prewarm,
# the engine's metrics and the sampler's threefry stream on the card
# ---------------------------------------------------------------------------

CKPT_MODEL = "llama3.2:1b"
CKPT_TOKENS = 32
# the engine's series a torch worker exports (the JAX worker's names)
CKPT_SERIES = (
    "gridllm_engine_tokens_total", "gridllm_engine_step_duration_seconds",
    "gridllm_engine_batch_occupancy", "gridllm_engine_kv_pages_used",
    "gridllm_engine_kv_pages_free", "gridllm_engine_kv_pages_cached",
    "gridllm_engine_host_sched_seconds", "gridllm_engine_dispatch_seconds",
    "gridllm_engine_device_step_seconds", "gridllm_prefix_cache_hit_rate",
    "gridllm_prefix_cache_hits_total", "gridllm_prefix_cache_misses_total",
    "gridllm_prefix_cache_evictions_total", "gridllm_prefix_cache_cow_copies_total",
    "gridllm_model_load_seconds", "gridllm_spec_proposed_tokens_total",
    "gridllm_spec_accepted_tokens_total", "gridllm_spec_rejected_tokens_total",
    "gridllm_spec_acceptance_rate", "gridllm_kernel_dispatch_total",
    "gridllm_device_memory_bytes", "gridllm_device_memory_headroom_bytes",
    "gridllm_device_memory_limit_bytes", "gridllm_weight_snapshot_bytes",
    "gridllm_weight_snapshot_models", "gridllm_weight_snapshot_events_total")
MAIN_PATH_KERNELS = ("flash_prefill", "ragged_attention", "paged_write_decode",
                     "paged_write_chunk")


def _ckpt_prompts() -> list[str]:
    """Four prompts, the last past the 1,024-token chunk (byte tokens)."""
    import random

    rng = random.Random(SEED + 11)
    return [_prompt(rng, n) for n in (120, 400, 800, 1500)]


def _ckpt_streams(engine) -> list[list[int]]:
    """The four prompts submitted at once and driven by step() (one
    admission schedule for every engine): greedy token streams."""
    from gridllm_torch.engine import GenerationRequest

    results: dict = {}

    def done(i):
        def cb(_delta, fin, res):
            if fin:
                results[i] = res
        return cb

    for i, p in enumerate(_ckpt_prompts()):
        engine.submit(GenerationRequest(id=f"ck{i}", prompt=p, on_chunk=done(i), options={
            "temperature": 0.0, "num_predict": CKPT_TOKENS}))
    for _ in range(100_000):
        if len(results) == 4:
            break
        engine.step()
    check(len(results) == 4, "checkpoint: a request never finished")
    for i in range(4):
        res = results[i]
        check(res.done_reason in ("length", "stop") and res.token_ids,
              f"checkpoint: request {i} finished {res.done_reason!r} ({res.error})")
    return [results[i].token_ids for i in range(4)]


def _scrape() -> tuple[set, dict]:
    """(metric names, {sample line name and labels: value}) of the port's
    registry in Prometheus text."""
    from gridllm_torch.obs import default_registry

    names, samples = set(), {}
    for line in default_registry().render().splitlines():
        if line.startswith("# TYPE "):
            names.add(line.split()[2])
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            samples[key] = float(value)
    return names, samples


def _jnp_dispatches(samples: dict) -> float:
    return sum(v for k, v in samples.items()
               if k.startswith("gridllm_kernel_dispatch_total{") and 'path="jnp"' in k)


def _ckpt_metrics(torch) -> dict:
    """C 1 on the card, after the phase's serves, park and restore: every
    series of CKPT_SERIES is defined (those the phase exercises with a
    sample), the plain path dispatched nothing, and the device-memory
    limit is the card's."""
    names, samples = _scrape()
    missing = [n for n in CKPT_SERIES if n not in names]
    check(not missing, f"checkpoint metrics: series missing: {missing}")
    for n in ("gridllm_engine_tokens_total", "gridllm_engine_device_step_seconds_count",
              "gridllm_prefix_cache_misses_total", "gridllm_model_load_seconds_count",
              "gridllm_kernel_dispatch_total", "gridllm_device_memory_bytes",
              "gridllm_weight_snapshot_events_total"):
        check(any(k.startswith(n + "{") or k == n for k in samples),
              f"checkpoint metrics: {n} has no sample")
    jnp = _jnp_dispatches(samples)
    check(jnp == 0, f"checkpoint metrics: {jnp} dispatches took the plain path")
    total = torch.cuda.mem_get_info()[1]
    limit = samples.get('gridllm_device_memory_limit_bytes{device="cuda:0"}')
    check(limit == total, f"checkpoint metrics: memory limit {limit} != {total}")
    cuda = {k.split('path="cuda"')[0]: v for k, v in samples.items()
            if k.startswith("gridllm_kernel_dispatch_total{") and 'path="cuda"' in k}
    return {"series_present": len(CKPT_SERIES), "jnp_dispatches": jnp,
            "cuda_dispatch_series": len(cuda), "memory_limit_bytes": limit,
            "headroom_bytes": samples.get('gridllm_device_memory_headroom_bytes{'
                                          'device="cuda:0"}')}


def _gumbel_ulps(torch, got, want):
    """|got - want| of two float32 Gumbel draws in units of the rounding the
    two logs of -log(-log(u)) allow: 1 ulp of the result plus 1 ulp of the
    inner log's value x carried through the outer log (ulp(x) / x)."""
    w = want.double()
    x = torch.exp(-w)

    def ulp(t):
        t = t.abs().float()
        return (torch.nextafter(t, torch.full_like(t, float("inf"))) - t).double()

    return ((got.double() - w).abs() / (ulp(w) + ulp(x) / x)).max().item()


def _rng_check(torch) -> dict:
    """C 2 on the card: the sampler's threefry bits, uniforms and key chains
    on CUDA equal the CPU's exactly over 64 seeds x 64 steps; the Gumbel
    draws within 2 ulp (`_gumbel_ulps`)."""
    from gridllm_torch.ops import sampling as smp

    seeds = [0, 1, -1, 7, -7, 12345, -54321, 2**31 - 1, -2**31] + [
        (i * 2654435761) % 2**32 - 2**31 for i in range(55)]
    s = torch.tensor(seeds, dtype=torch.int32).repeat_interleave(64)
    t = torch.tensor([0, 1, 2, 1000, 2**31 - 1] + list(range(3, 62)),
                     dtype=torch.int32).repeat(64)
    out = {}
    for dev in ("cpu", "cuda"):
        sd, st = s.to(dev), t.to(dev)
        key = smp.step_key(sd, st)
        u, g = smp._spec_keys(sd, st, 128)
        tu, tg = smp._spec_tree_keys(sd, st, 128, 6)
        out[dev] = {"key0": key[0], "key1": key[1], "bits": smp.random_bits(key, 128),
                    "uniform": smp.uniform(key, 128), "spec_u": u, "tree_u": tu,
                    "gumbel": smp.gumbel(key, 128), "spec_g": g, "tree_g": tg}
    exact = {k: torch.equal(out["cpu"][k], out["cuda"][k].cpu())
             for k in ("key0", "key1", "bits", "uniform", "spec_u", "tree_u")}
    check(all(exact.values()), f"checkpoint rng: CUDA bits differ from the CPU's: {exact}")
    ulps = {k: _gumbel_ulps(torch, out["cuda"][k].cpu(), out["cpu"][k])
            for k in ("gumbel", "spec_g", "tree_g")}
    check(max(ulps.values()) <= 2.0, f"checkpoint rng: Gumbel draws apart: {ulps}")
    same = {k: (out["cuda"][k].cpu() == out["cpu"][k]).float().mean().item()
            for k in ("gumbel", "spec_g", "tree_g")}
    return {"grid": [64, 64], "exact": sorted(exact), "gumbel_max_ulps": ulps,
            "gumbel_bit_equal_share": same}


class _HostMemory:
    """Host memory over a block: the growth of ru_maxrss (the process's
    peak RSS), the peak of the current RSS sampled every millisecond above
    its value at entry (ru_maxrss moves only past the earlier peak), and
    the bytes the CUDA caching host allocator holds after (pinned
    blocks)."""

    def __init__(self, torch):
        self.torch = torch

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096

    def __enter__(self):
        import resource

        self._stop = threading.Event()
        self.start = self.peak = self._rss()
        self.maxrss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

        def sample():
            while not self._stop.wait(0.001):
                self.peak = max(self.peak, self._rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        import resource

        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        stats = getattr(self.torch.cuda, "host_memory_stats", lambda: {})()
        self.reading = {
            "ru_maxrss_growth_mb": (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                                    - self.maxrss0) / 1024,
            "rss_peak_growth_mb": (self.peak - self.start) / 2**20,
            "pinned_host_allocator_mb": stats.get("allocated_bytes.current", 0) / 2**20,
        }


def _checkpoint_child(torch, path: str, prewarm: bool) -> dict:
    """One cold process of the checkpoint phase: llama3.2:1b from `path`
    with GRIDLLM_PREWARM_COMPILES on or off, then one request (its time to
    the first host-visible token); the load's peak host memory growth."""
    import os

    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine

    os.environ["GRIDLLM_PREWARM_COMPILES"] = "1" if prewarm else "0"
    torch.cuda.init()
    torch.zeros((), device="cuda")   # the context, before the memory reading
    t0 = time.perf_counter()
    with _HostMemory(torch) as mem:
        engine = InferenceEngine(EngineConfig(model=CKPT_MODEL, checkpoint_path=path),
                                 device="cuda")
    ready_s = time.perf_counter() - t0
    check(engine.load_source == "checkpoint", f"child: weights from {engine.load_source}")
    check((engine.prewarm_duration_ns > 0) == prewarm, "child: prewarm did not run as set")
    t1 = time.perf_counter()
    res = engine.generate(GenerationRequest(id="first", prompt=_ckpt_prompts()[1], options={
        "temperature": 0.0, "num_predict": 16}))
    check(res.done_reason in ("length", "stop"), f"child: {res.done_reason} {res.error}")
    weights = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    return {"prewarm": prewarm, "load_s": engine.load_duration_ns / 1e9,
            "load_gb_per_s": weights / engine.load_duration_ns,
            "prewarm_ms": engine.prewarm_duration_ns / 1e6, "ready_s": ready_s,
            "first_request_ttft_ms": res.prompt_eval_duration_ns / 1e6,
            "first_request_wall_ms": (time.perf_counter() - t1) * 1e3,
            "load_host_memory": mem.reading}


def _checkpoint_children(path: str) -> list:
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    runs = []
    for prewarm in (False, True):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--checkpoint-child", path, "--prewarm", str(int(prewarm))],
                              capture_output=True, text=True, timeout=300, cwd=str(REPO))
        (out_dir / f"checkpoint_child_prewarm{int(prewarm)}.txt").write_text(
            f"rc={proc.returncode}\n== stdout\n{proc.stdout}\n== stderr\n{proc.stderr}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        res = json.loads(lines[-1]) if lines else {}
        check(proc.returncode == 0 and res.get("ok"),
              f"checkpoint: child (prewarm {prewarm}) failed (rc {proc.returncode}): "
              f"{proc.stderr[-3000:]}")
        runs.append(res)
    return runs


def _weight_bytes(engine) -> int:
    return sum(p.numel() * p.element_size() for p in engine.model.parameters())


def phase_checkpoint(torch) -> dict:
    """llama3.2:1b at full width (bf16, tied embeddings): its random weights
    written with save_checkpoint into a temporary directory (removed at the
    end), served from the file (parameters equal bit for bit, the four
    prompts' streams equal the random-init engine's, the four main-path
    kernels launched and no plain version run), served again by an
    unregistered name from its config.json, parked in the weight snapshot
    tier (device memory falls by the weights' bytes) and restored from it;
    two cold child processes with prewarm off and on; the port's Prometheus
    series after the serve; the sampler's threefry stream on CUDA against
    the CPU."""
    import os
    import shutil
    import tempfile

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.engine import loader
    from gridllm_torch.ops import cuda_kernels as ck

    out: dict = {"phase": "checkpoint", "model": CKPT_MODEL, "card": card_line()}
    tmp = tempfile.mkdtemp(prefix="gridllm-ckpt-")
    try:
        gc.collect()
        torch.cuda.empty_cache()
        src = InferenceEngine(EngineConfig(model=CKPT_MODEL), device="cuda")
        want = _ckpt_streams(src)
        weights = _weight_bytes(src)
        t0 = time.perf_counter()
        nbytes = loader.save_checkpoint(src.model, src.cfg, tmp, torch.bfloat16)
        write_s = time.perf_counter() - t0
        out["write"] = {"bytes": nbytes, "seconds": write_s, "gb_per_s": nbytes / write_s / 1e9}

        cfg = EngineConfig(model=CKPT_MODEL, checkpoint_path=tmp)
        with _HostMemory(torch) as mem:
            eng = InferenceEngine(cfg, device="cuda")
        check(eng.load_source == "checkpoint", f"checkpoint: loaded from {eng.load_source}")
        differ = [n for (n, p), (_, q) in zip(src.model.named_parameters(),
                                             eng.model.named_parameters())
                  if not torch.equal(p, q)]
        check(not differ, f"checkpoint: parameters differ from the written ones: {differ}")
        load_s = eng.load_duration_ns / 1e9
        del src
        gc.collect()
        torch.cuda.empty_cache()
        ck.reset_launch_counts()
        with _PlainWatch(torch) as plain:
            got = _ckpt_streams(eng)
        counts = ck.launch_counts()
        check(got == want, "checkpoint: streams from the file differ from random init's")
        for name in MAIN_PATH_KERNELS:
            check(counts[name] > 0, f"checkpoint: {name} never launched: {counts}")
        check(not any(plain.counts.values()),
              f"checkpoint: a plain version ran on the card: {plain.counts}")
        out["load"] = {"seconds": load_s, "gb_per_s": weights / load_s / 1e9,
                       "weight_bytes": weights, "file_bytes": nbytes,
                       "host_memory": mem.reading,
                       "streams_equal_random_init": True, "launches": counts,
                       "plain_calls_on_card": plain.counts}

        byname = InferenceEngine(EngineConfig(model="local-llama-1b", checkpoint_path=tmp),
                                 device="cuda")
        check(byname.cfg.head_dim_ == 64 and byname.cfg.tie_embeddings
              and byname.cfg.rope_scaling == eng.cfg.rope_scaling,
              f"checkpoint: config.json read back as {byname.cfg}")
        check(_ckpt_streams(byname) == want, "checkpoint: streams by name differ")
        out["by_name"] = {"model": byname.cfg.name, "load_s": byname.load_duration_ns / 1e9,
                          "streams_equal_random_init": True}
        del byname
        gc.collect()
        torch.cuda.empty_cache()

        os.environ["GRIDLLM_WEIGHT_SNAPSHOT_BYTES"] = str(2 * weights)
        loader.reset_weight_snapshot_tier()
        try:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            parked = eng.park_weights()
            park_s = time.perf_counter() - t0
            freed = before - torch.cuda.memory_allocated()
            check(parked and freed >= weights,
                  f"checkpoint: parking freed {freed} bytes of {weights} (parked {parked})")
            del eng
            gc.collect()
            back = InferenceEngine(cfg, device="cuda")
            check(back.load_source == "snapshot", f"checkpoint: reload from {back.load_source}")
            restore_s = back.load_duration_ns / 1e9
            check(_ckpt_streams(back) == want, "checkpoint: streams after the restore differ")
            out["snapshot"] = {"park_s": park_s, "freed_bytes": freed,
                               "restore_s": restore_s,
                               "restore_gb_per_s": weights / restore_s / 1e9,
                               "tier": loader.weight_snapshot_tier().stats(),
                               "streams_equal_random_init": True}
            del back
        finally:
            del os.environ["GRIDLLM_WEIGHT_SNAPSHOT_BYTES"]
            loader.reset_weight_snapshot_tier()
            gc.collect()
            torch.cuda.empty_cache()
        # after the serves, the park and the restore
        out["metrics"] = _ckpt_metrics(torch)
        out["prewarm_children"] = _checkpoint_children(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["rng"] = _rng_check(torch)
    return out


# ---------------------------------------------------------------------------
# int8: the resident int8 KV pool (kv_int8) and ragged_attention's int8 leg
# ---------------------------------------------------------------------------


def _quant_pools(torch, inp: Inputs, n_layers: int, n_pages: int, d: int = D):
    """An int8 K and V pool ([L, P, PS, KVH, d] values and [L, P, PS]
    scales) holding the quantization of seeded normal rows, each scaled by
    10 ** U(-1, 1): the per-row scales span two decades, so a reader that
    ignores the scale, or takes one per page or another layer's, misses."""
    from gridllm_torch.ops.kvcache import QuantPages, quantize_kv_rows

    pools = []
    for _ in range(2):
        pool = QuantPages.zeros((n_layers, n_pages, PS, KVH, d), "cuda")
        for li in range(n_layers):
            x = inp.randn(n_pages * PS, KVH, d, dtype=torch.float32)
            x *= 10.0 ** (torch.rand((n_pages * PS, 1, 1), generator=inp.gen, device="cuda")
                          * 2 - 1)
            q, sc = quantize_kv_rows(x)
            pool.data[li] = q.reshape(n_pages, PS, KVH, d)
            pool.scale[li] = sc.reshape(n_pages, PS)
            del x, q, sc
        pools.append(pool)
    return pools


def _int8_cases(torch, inp: Inputs, dtype):
    """(name, pools, kwargs, chunk_valid_rows) cases of the int8 leg, at
    layer 1 of 2-layer pools, q scaled by LONG_Q_SCALE: decode groups
    S = 8 at 1024 cached, a Td = 5 group over page straddles and an empty
    slot, a 1024-row chunk after 1024, one mixed launch (chunk + decode
    groups), window 4096 with softcap 30, D = 64, a chunk whose 20-page
    table ends inside it (its rows past the capacity cut), then on a
    512-entry table a 1024-row chunk after 16,384 and groups at
    24000-32763 cached tokens. In bf16 every chunk takes the tensor-core
    route (the int8 tiles converted in shared memory), in float32 the
    CUDA-core one."""
    pools = _quant_pools(torch, inp, 2, S * MAXP)

    def q_of(*shape, d=D):
        return inp.randn(*shape, d, dtype=dtype) * LONG_Q_SCALE

    def group(lengths, td, table=None, d=D):
        table = inp.page_table(lengths, extra=td) if table is None else table
        return dict(q_group=q_of(S, td, H, d=d), page_table=table,
                    group_lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
                    k_group=inp.randn(S, td, KVH, d, dtype=dtype),
                    v_group=inp.randn(S, td, KVH, d, dtype=dtype))

    def chunk(row, c, start, valid, d=D):
        return dict(q_chunk=q_of(1, c, H, d=d), chunk_row=row, chunk_start=start,
                    chunk_total=start + valid, k_chunk=inp.randn(c, KVH, d, dtype=dtype),
                    v_chunk=inp.randn(c, KVH, d, dtype=dtype))

    straddle = [0, 1, 63, 64, 65, 700, 1500, 4000]
    deep = [4100, 5000, 6000, 7000, 7500, 8000, 8100, 8186]
    rows = inp.page_table([MAXP * PS - 1] * S)
    cases = [
        ("decode_s8_1024", pools, group([1024] * S, 1), None),
        ("group_td5", pools, group(straddle, 5), None),
        ("chunk_1024_after_1024", pools, chunk(rows[2], 1024, 1024, 1000), 1000),
        ("mixed_chunk_and_decode", pools,
         {**chunk(rows[2], 1024, 1024, 1024), **group(straddle, 1)}, 1024),
        ("window4096_softcap30", pools,
         {**chunk(rows[3], 256, 5120, 256), **group(deep, 1, table=rows), "window": 4096,
          "softcap": 30.0}, 256),
    ]
    d64 = _quant_pools(torch, inp, 2, S * MAXP, d=64)
    cases.append(("d64_mixed", d64, {**chunk(rows[2], 256, 512, 256, d=64),
                                     **group(straddle, 5, d=64)}, 256))
    # 20 pages hold 1280 positions: fresh rows from 256 into the chunk are cut
    cases.append(("chunk_past_capacity", pools,
                  chunk(rows[4][:20].contiguous(), 512, 1024, 500), 500))
    long_pools = _quant_pools(torch, inp, 2, S * LONG_MAXP)
    table = torch.randperm(S * LONG_MAXP, generator=inp.gen, device="cuda").to(torch.int32)
    table = table.reshape(S, LONG_MAXP).contiguous()
    cases.append(("chunk_1024_after_16384", long_pools, chunk(table[0], 1024, 16384, 1000),
                  1000))
    lengths = [24000, 24001, 26000, 28000, 30000, 31000, 32000, LONG_T - 5]
    for td in (1, 5):
        cases.append((f"groups_td{td}_24k_to_32k", long_pools, group(lengths, td, table=table),
                      None))
    return cases


def _int8_kernel_cases(torch, inp: Inputs) -> tuple[list, float]:
    """The int8 leg against its plain version in bf16 and float32 compute,
    each case held to the row-relative error at the kernel's tolerance and
    to its route's leg counters: a chunk launches `.chunk` in bf16 (the
    tensor cores) and `.chunk_cores` in float32, never the other, and
    every launch counts `.int8`."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import ragged_paged_attention_ref
    from gridllm_torch.ops.kernels import F32_TOL, by_name

    legs = ("chunk", "chunk_cores", "group", "int8")
    cases, worst_abs = [], 0.0
    for dtype, tol in ((torch.bfloat16, by_name("ragged_attention").rtol),
                       (torch.float32, F32_TOL)):
        dname = str(dtype).split(".")[-1]
        for name, (kp, vp), kw, valid in _int8_cases(torch, inp, dtype):
            kw = dict(kw)
            cap, window = kw.pop("softcap", 0.0), kw.pop("window", 0)
            legs0 = {leg: ck.LEG_LAUNCHES[f"ragged_attention.{leg}"] for leg in legs}
            oc, og = ck.ragged_attention(kp.data, vp.data, PS, layer=1, softcap=cap,
                                         window=window, k_scale=kp.scale, v_scale=vp.scale,
                                         **kw)
            ran = {leg: ck.LEG_LAUNCHES[f"ragged_attention.{leg}"] - legs0[leg] for leg in legs}
            if oc is not None:
                want = (1, 0) if dtype == torch.bfloat16 else (0, 1)
                check((ran["chunk"], ran["chunk_cores"]) == want,
                      f"ragged_attention int8 {dname} {name}: chunk routes {ran}")
            check(ran["int8"] == ran["chunk"] + (ran["chunk_cores"] or ran["group"]),
                  f"ragged_attention int8 {dname} {name}: a launch missed the int8 leg {ran}")
            wc, wg = ragged_paged_attention_ref(kp, vp, PS, layer=1, logit_softcap=cap,
                                                window=window, **kw)
            torch.cuda.synchronize()
            rel = err = 0.0
            if oc is not None:
                rel = _rel_err(oc[:, :valid], wc[:, :valid])
                err = _max_err(oc[:, :valid], wc[:, :valid])
            if og is not None:
                rel, err = max(rel, _rel_err(og, wg)), max(err, _max_err(og, wg))
            cases.append({"kernel": "ragged_attention.int8", "dtype": dname, "case": name,
                          "launches": ran, "max_rel_err": rel, "max_abs_err": err})
            check(rel <= tol, f"ragged_attention int8 {dname} {name}: relative err {rel} > {tol}")
            if dtype == torch.bfloat16:
                worst_abs = max(worst_abs, err)
            del kw, oc, og, wc, wg
        torch.cuda.empty_cache()
    return cases, worst_abs


def _int8_smem_refusal(torch, inp: Inputs) -> str:
    """A chunk on an int8 pool whose staged table row would pass the
    card's shared memory (8,500 pages of prefix: 34,000 bytes beside the
    kernel's 199,808) is refused with a clear error and launches nothing."""
    from gridllm_torch.ops import cuda_kernels as ck

    bf16, c, start = torch.bfloat16, 128, 8500 * PS
    kp, vp = _quant_pools(torch, inp, 1, 64)
    kw = dict(q_chunk=inp.randn(1, c, H, D, dtype=bf16),
              chunk_row=torch.zeros(8600, dtype=torch.int32, device="cuda"),
              chunk_start=start, chunk_total=start + c, k_chunk=inp.randn(c, KVH, D, dtype=bf16),
              v_chunk=inp.randn(c, KVH, D, dtype=bf16))
    before, msg = ck.LAUNCHES["ragged_attention"], ""
    try:
        ck.ragged_attention(kp.data, vp.data, PS, k_scale=kp.scale, v_scale=vp.scale, layer=0,
                            **kw)
    except RuntimeError as e:
        msg = str(e)
    check("shared memory" in msg and ck.LAUNCHES["ragged_attention"] == before,
          f"int8: a chunk past the shared memory was not refused: {msg!r}")
    return msg


def _int8_timing(torch, inp: Inputs) -> dict:
    """The int8 leg at the fp leg's timing shapes (bf16 compute), each
    timed in turns with the fp leg on a bf16 pool (fp, int8, int8, fp):
    decode groups, the chunk region C = 1,024 after 1,024 and after 16,384
    cached tokens (the tensor-core route, whose first call runs under
    torch.cuda.set_sync_debug_mode("error")), the verify width. Beside the
    chunks, as a yardstick only, SDPA with a causal mask on K/V gathered
    and dequantized beforehand (no paging, no dequantization in the call)."""
    import torch.nn.functional as F

    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import ragged_paged_attention_ref
    from gridllm_torch.ops.kvcache import gather_kv

    bf16 = torch.bfloat16
    (k8, v8), (kf, vf) = _quant_pools(torch, inp, 1, S * MAXP), inp.pools(1, bf16)
    lengths = [1024] * S
    table = inp.page_table(lengths, extra=5)
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    c = 1024
    # a 400-entry table row of the pool's pages: 25,600 positions
    long_row = torch.randperm(S * MAXP, generator=inp.gen, device="cuda")[:400].to(torch.int32)

    def chunk(start, row):
        return dict(q_chunk=inp.randn(1, c, H, D, dtype=bf16), chunk_row=row,
                    chunk_start=start, chunk_total=start + c,
                    k_chunk=inp.randn(c, KVH, D, dtype=bf16),
                    v_chunk=inp.randn(c, KVH, D, dtype=bf16))

    shapes = {
        "decode": dict(q_group=inp.randn(S, 1, H, D, dtype=bf16), page_table=table,
                       group_lengths=glens, k_group=inp.randn(S, 1, KVH, D, dtype=bf16),
                       v_group=inp.randn(S, 1, KVH, D, dtype=bf16)),
        "chunk": chunk(1024, table[0]),
        "chunk_16384": chunk(16384, long_row),
        "verify_td5": dict(q_group=inp.randn(1, 5, H, D, dtype=bf16), page_table=table[:1],
                           group_lengths=glens[:1], k_group=inp.randn(1, 5, KVH, D, dtype=bf16),
                           v_group=inp.randn(1, 5, KVH, D, dtype=bf16)),
    }
    # bytes: int8 K and V of the cached rows, 4 bytes of scale per row each,
    # fresh K/V and q/out in bf16; operations: 2 products of 2 flops
    row8, row16 = KVH * D * 2, KVH * D * 2 * 2

    def chunk_work(start):
        return (start * (row8 + 8) + c * row16 + 2 * c * H * D * 2,
                4 * H * D * c * (start + (c + 1) / 2))

    work = {
        "decode": (sum(lengths) * (row8 + 8) + S * row16 + 2 * S * H * D * 2,
                   4 * H * D * (sum(lengths) + S)),
        "chunk": chunk_work(1024),
        "chunk_16384": chunk_work(16384),
        "verify_td5": (1024 * (row8 + 8) + 5 * row16 + 2 * 5 * H * D * 2,
                       4 * H * D * 5 * (1024 + 3)),
    }

    def sdpa_chunk(kw):
        """SDPA over the int8 prefix gathered and dequantized to bf16 plus
        the fresh rows, with the chunk's causal mask."""
        start = kw["chunk_start"]
        k_all, v_all = gather_kv(k8.layer(0), v8.layer(0), kw["chunk_row"], PS)
        k_all = torch.cat([k_all[:start].to(bf16), kw["k_chunk"]])[None].transpose(1, 2)
        v_all = torch.cat([v_all[:start].to(bf16), kw["v_chunk"]])[None].transpose(1, 2)
        mask = (torch.arange(start + c, device="cuda")[None, :]
                <= start + torch.arange(c, device="cuda")[:, None])
        qt = kw["q_chunk"].transpose(1, 2)
        return time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, k_all, v_all, attn_mask=mask, enable_gqa=True))

    out = {}
    for name, kw in shapes.items():
        def int8():
            ck.ragged_attention(k8.data, v8.data, PS, k_scale=k8.scale, v_scale=v8.scale,
                                layer=0, **kw)

        def fp():
            ck.ragged_attention(kf, vf, PS, layer=0, **kw)

        if name.startswith("chunk"):
            _no_host_sync(torch, int8)
        runs = {"fp": [time_ms(torch, fp)], "int8": []}
        runs["int8"] += [time_ms(torch, int8), time_ms(torch, int8)]
        runs["fp"].append(time_ms(torch, fp))
        dev_runs = {"fp": [device_ms(torch, fp)], "int8": []}
        dev_runs["int8"] += [device_ms(torch, int8), device_ms(torch, int8)]
        dev_runs["fp"].append(device_ms(torch, fp))
        b, op = bound_ms(*work[name])
        ms, fp_ms = statistics.mean(runs["int8"]), statistics.mean(runs["fp"])
        out[name] = {"ms": ms, "fp_ms": fp_ms, "int8_over_fp": ms / fp_ms, "runs_ms": runs,
                     "device_ms": statistics.mean(dev_runs["int8"]),
                     "fp_device_ms": statistics.mean(dev_runs["fp"]),
                     "device_runs_ms": dev_runs,
                     "bound_ms": b, "bound_by": op, "library_ms": None}
        if name != "chunk_16384":
            out[name]["plain_ms"] = time_ms(torch, lambda: ragged_paged_attention_ref(
                k8, v8, PS, layer=0, **kw), iters=3)
        if name.startswith("chunk"):
            out[name]["no_host_sync"] = True
            out[name]["sdpa_gathered_ms"] = sdpa_chunk(kw)
    out["decode"]["shape"] = f"decode group S={S} Td=1 context=1024, int8 pool, bf16 q"
    out["chunk"]["shape"] = "chunk region C=1024 after 1024 cached, int8 pool, bf16 q"
    del k8, v8, kf, vf
    torch.cuda.empty_cache()
    return out


def _int8_model(torch) -> dict:
    """llama3:8b cut to 2 layers, full width, float32, with an int8 pool:
    the same steps (bucket prefill, decode steps, mixed steps admitting a
    second slot, verify steps of K+1 = 5) through the kernels and through
    the plain versions on the card, the logits of each step compared."""
    import contextlib
    import dataclasses
    from unittest import mock

    from gridllm_torch.models import llama
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_ref, ragged_paged_attention_ref
    from gridllm_torch.ops.kernels import F32_TOL
    from gridllm_torch.ops.kvcache import PagedKVCache, rollback_to_length

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3:8b"), num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    model = llama.Llama(cfg, dtype=torch.float32, device="cuda").init_params(gen)
    toks = torch.randint(0, cfg.vocab_size, (320,), generator=gen, device="cuda",
                         dtype=torch.int32)
    rows = torch.arange(32, device="cuda", dtype=torch.int32).reshape(4, 8)

    def steps(plain: bool) -> list:
        cache = PagedKVCache.create(cfg.num_layers, 32, PS, KVH, D, 4, 8, device="cuda",
                                    kv_int8=True)
        ctx = (mock.patch.multiple(llama, ragged_paged_attention=ragged_paged_attention_ref,
                                   attention_prefill=attention_prefill_ref)
               if plain else contextlib.nullcontext())
        out, cur = [], torch.zeros(4, dtype=torch.int32, device="cuda")
        one = torch.tensor([True, False, False, False], device="cuda")
        with ctx:
            logits, _ = model.prefill(torch.cat([toks[:192], toks[:64] * 0]), 192, cache, 0,
                                      rows[0])
            out.append(logits)
            for pos in range(192, 208):
                cur[0] = toks[pos]
                out.append(model.decode_step(cur, cache, one)[0][0])
            for start, pos in ((0, 208), (64, 209)):
                cur[0] = toks[pos]
                chunk_logits, dec_logits, _ = model.mixed_step(
                    toks[start:start + 64], start, 64, 1, rows[1], cur, cache, one)
                out += [chunk_logits, dec_logits[0]]
            both = torch.tensor([True, True, False, False], device="cuda")
            for _ in range(2):
                lens = cache.lengths.tolist()
                cand = torch.zeros((4, 5), dtype=torch.int32, device="cuda")
                for s in (0, 1):
                    cand[s] = toks[lens[s]:lens[s] + 5]
                logits, _ = model.verify_step(cand, cache, both)
                out.append(logits[:2])
                rollback_to_length(cache, cache.lengths + 5 * both.to(torch.int32))
        torch.cuda.synchronize()
        return out

    ck.reset_launch_counts()
    kernel_out = steps(plain=False)
    kernel_counts = ck.launch_counts()
    ck.reset_launch_counts()
    plain_out = steps(plain=True)
    plain_counts = ck.launch_counts()
    err = max(float((a - b).abs().max()) for a, b in zip(kernel_out, plain_out))
    check(kernel_counts["ragged_attention.int8"] > 0
          and kernel_counts["ragged_attention.int8"] == kernel_counts["ragged_attention"],
          f"int8 model: the kernel path's launches {kernel_counts}")
    check(not any(plain_counts.values()), f"int8 model: the plain path launched {plain_counts}")
    check(err <= F32_TOL, f"int8 model: kernel path differs from the plain versions by {err}")
    del model
    torch.cuda.empty_cache()
    return {"config": "llama3:8b, 2 layers, float32, kv_int8", "logit_sets_compared":
            len(kernel_out), "max_abs_err": err, "kernel_launches": kernel_counts}


def _int8_serve(torch) -> dict:
    """llama3:8b bf16 with kv_int8=True (spec decode and ragged attention
    on, the defaults) serving the serve phase's eight concurrent requests,
    then a warm prefix-cache repeat; counts from 0 before the first."""
    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.kvcache import QuantPages

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = Served(torch, InferenceEngine(EngineConfig(model="llama3:8b", kv_int8=True),
                                        device="cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    engine = srv.engine
    check(isinstance(engine.cache.k, QuantPages), "int8 serve: the pool is not int8")
    vocab, slots, k1 = srv.vocab, engine.config.max_slots, engine.config.spec_k + 1
    _, short, _, batch_a = _serve_prompts()
    engine.start()
    ck.reset_launch_counts()
    srv.calls.clear()
    res_a, wall = srv.run(batch_a)
    (warm,), wall_warm = srv.run([(short[2], 64)])
    counts = ck.launch_counts()
    check(warm.cached_tokens > 0, "int8 serve: the repeat missed the prefix cache")
    layers, steps = engine.cfg.num_layers, engine.spec_stats["steps"]
    # every chunk region on the tensor cores: one chunk launch per layer of
    # each chunked admission and mixed step, none on the CUDA cores
    chunk_steps = srv.calls.get("prefill_chunk", 0) + srv.calls.get("mixed_step", 0)
    check(counts["ragged_attention.chunk_cores"] == 0,
          f"int8 serve: a chunk ran on the CUDA cores: {counts}")
    check(counts["ragged_attention.chunk"] == layers * chunk_steps > 0,
          f"int8 serve: {counts['ragged_attention.chunk']} chunk launches, {chunk_steps} "
          f"chunk and mixed steps of {layers} layers")
    check(counts["ragged_attention.int8"] > 0 and counts["flash_prefill"] > 0,
          f"int8 serve: a kernel of its path never launched: {counts}")
    check(counts["ragged_attention.int8"] == counts["ragged_attention"],
          f"int8 serve: a ragged launch missed the int8 leg: {counts}")
    check(counts["ragged_attention.int8"] >= layers * steps > 0,
          f"int8 serve: {counts['ragged_attention.int8']} int8 launches, {steps} verify steps")
    never = ("paged_write_decode", "paged_write_chunk", "paged_decode", "prefix_chunk",
             "flash_prefill_streamed")
    check(all(counts[k] == 0 for k in never),
          f"int8 serve: a kernel of another path launched: {counts}")
    matching = 0
    for a, b in zip(res_a[2].token_ids, warm.token_ids):
        if a != b:
            break
        matching += 1
    alloc = engine.memory_arrays()["alloc"]
    bf16_bpp = 2 * layers * PS * KVH * D * 2
    ratio = alloc["bytesPerPage"] / bf16_bpp
    check(alloc["kvInt8"] and abs(ratio - 65792 / 131072) < 1e-3,
          f"int8 serve: {alloc['bytesPerPage']} bytes per page, {ratio} of bf16")
    out = {
        **srv.summary(res_a, wall, {(vocab,), (slots, vocab), (slots, k1, vocab)}),
        "model": "llama3:8b", "dtype": "bfloat16", "kv_int8": True, "load_s": load_s,
        "warm_cached_tokens": warm.cached_tokens, "warm_wall_s": wall_warm,
        "warm_ttft_ms": warm.prompt_eval_duration_ns / 1e6,
        "batched_warm_repeat_tokens_matching_cold": f"{matching}/{len(warm.token_ids)}",
        "pool_bytes_per_page": alloc["bytesPerPage"], "bf16_pool_bytes_per_page": bf16_bpp,
        "pool_bytes_over_bf16": ratio, "launches": counts, "chunk_steps": chunk_steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    _free(torch, srv)
    return out


def phase_int8(torch) -> dict:
    """The int8 KV pool: the int8 leg's kernel cases and timing, the
    2-layer float32 cut through kernels and plain versions, then the
    engine serving with kv_int8 (see the module docstring)."""
    inp = Inputs(torch, SEED + 7)
    cases, worst_abs = _int8_kernel_cases(torch, inp)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "int8_kernel_cases.json").write_text(json.dumps(cases, indent=1))
    refusal = _int8_smem_refusal(torch, inp)
    timing = _int8_timing(torch, inp)
    model = _int8_model(torch)
    serve = _int8_serve(torch)
    return {"phase": "int8", "card": card_line(), "cases": len(cases), "smem_refusal": refusal,
            "max_rel_err": max(c["max_rel_err"] for c in cases),
            "max_abs_err_bf16": worst_abs, "timing": timing, "model": model, "serve": serve,
            "launches": serve["launches"]["ragged_attention.int8"]}


# ---------------------------------------------------------------------------
# profiler: the engine's runner thread live under torch.profiler
# ---------------------------------------------------------------------------

# one child: two took 119 s of a 1,030 s run with the sched phase on a
# slow host, near the 1,200 s limit
PROFILER_RUNS = 2
PROFILER_MID_FLIGHT = 4   # captures opened and closed while a batch decodes


def _profiler_child(torch) -> dict:
    """One child of the profiler phase: llama3:8b bf16 with the engine's
    defaults (n-gram speculation on), its runner thread live, serves eight
    concurrent requests inside one capture of InferenceEngine.profile()
    (a torch.profiler.profile with CPU and CUDA activity, started and
    stopped on the runner thread between steps), then eight more while
    PROFILER_MID_FLIGHT captures open and close mid-decode; then, with the
    runner idle, a torch.profiler capture that the engine did not start
    must be refused: the request fails with an error naming profile().
    faulthandler prints every thread's Python stack if the process dies
    by a signal."""
    import faulthandler

    from torch.profiler import ProfilerActivity, profile

    from gridllm_torch.engine import EngineConfig, InferenceEngine

    faulthandler.enable(all_threads=True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA

    def kernels(prof) -> int:
        # read off the raw results: building the Python event list of a
        # capture of ~200k kernels takes minutes
        return sum(e.device_type() == cuda for e in prof.profiler.kineto_results.events())

    seconds = {}
    t0 = time.perf_counter()
    srv = Served(torch, InferenceEngine(EngineConfig(model="llama3:8b"), device="cuda"))
    engine = srv.engine
    engine.start()
    _, _, _, batch = _serve_prompts()
    seconds["load"] = time.perf_counter() - t0
    with engine.profile(activities=activities) as prof:   # 16 tokens each: a short trace
        srv.run([(p, 16) for p, _ in batch])
    seconds["batch_in_one_capture"] = time.perf_counter() - t0 - seconds["load"]
    traced = [kernels(prof)]
    t1 = time.perf_counter()
    box: list = []
    th = threading.Thread(target=lambda: box.append(srv.run([(p, 160) for p, _ in batch])))
    th.start()
    deadline = time.time() + 300
    mid_flight = []
    for _ in range(PROFILER_MID_FLIGHT):
        while (sum(s["generated"] for s in engine.batch_state()["slots"].values()) < 8
               and time.time() < deadline and th.is_alive()):
            time.sleep(0.01)
        with engine.profile(activities=activities) as prof:
            time.sleep(0.3)
        traced.append(kernels(prof))
        mid_flight.append(len(engine.batch_state()["slots"]))
    th.join(timeout=600)
    seconds["batch_across_captures"] = time.perf_counter() - t1
    check(not th.is_alive() and box, "profiler: the second batch did not finish")
    check(all(n > 0 for n in traced), f"profiler: device kernels traced per capture {traced}")
    check(min(mid_flight) > 0, f"profiler: slots decoding at each capture's end {mid_flight}")
    check(bool(srv.finite), "profiler: non-finite logits")
    from gridllm_torch.engine import GenerationRequest

    with profile(activities=activities):
        refused = engine.generate(GenerationRequest(id="foreign", prompt=batch[0][0],
                                                    options={"num_predict": 8}))
    check(refused.done_reason == "error" and "InferenceEngine.profile()" in refused.error,
          f"profiler: a foreign capture was not refused: {refused.done_reason!r} "
          f"{refused.error!r}")
    out = {"requests": 2 * len(batch) + 1, "device_kernels_traced": traced,
           "slots_decoding_at_capture_ends": mid_flight,
           "verify_steps": engine.spec_stats["steps"], "foreign_capture_refused": True,
           "seconds": seconds}
    _free(torch, srv)
    return out


def phase_profiler(torch) -> dict:
    """PROFILER_RUNS children, each `chip_smoke.py --profiler-child`: the
    phase fails if a child dies by a signal or fails its checks. Each
    child's output goes to chiprun_out/profiler_child_<i>.txt."""
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    runs = []
    for i in range(PROFILER_RUNS):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--profiler-child"], capture_output=True, text=True,
                              timeout=600, cwd=str(REPO))
        (out_dir / f"profiler_child_{i}.txt").write_text(
            f"rc={proc.returncode}\n== stdout\n{proc.stdout}\n== stderr\n{proc.stderr}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        res = json.loads(lines[-1]) if lines else {}
        runs.append({"rc": proc.returncode, "seconds": time.perf_counter() - t0, **res})
        check(proc.returncode >= 0, f"profiler: child {i} died by signal {-proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        check(proc.returncode == 0 and res.get("ok"),
              f"profiler: child {i} failed (rc {proc.returncode}): {proc.stderr[-3000:]}")
    return {"phase": "profiler", "runs": runs}


# llama3.1:8b long-context engine: 512 pages of 64 per slot (32768 tokens),
# whole prompts up to the 32768 bucket (streamed), a 24001-token prompt
LONG_ENGINE = dict(model="llama3.1:8b", page_size=64, max_pages_per_slot=512, num_pages=1280,
                   prefill_buckets=(64, 256, 1024, 4096, 32768), prefill_chunk=32768)
LONG_T, LONG_LEN, LONG_MAXP = 32768, 24001, 512
# The long kernel cases scale q by 4 (logits ~ N(0, 16)): each row's
# softmax is then held by a few keys, so outputs stay O(1) at any length,
# and a kernel that drops or misplaces keys far back moves the rows whose
# keys those were by O(1). Unit-normal q would average ~n keys into
# outputs of std ~1/sqrt(n), under an absolute bf16 tolerance. Each case
# is held to the row-relative error (`_rel_err`) at the kernel's tolerance.
LONG_Q_SCALE = 4.0


def _streamed_cases(inp: Inputs):
    """(name, dtype, q/k/v shape args, seq_lens, window, softcap) cases of
    flash_prefill_streamed, each at a T its routing sends it."""
    bf16, f32 = inp.torch.bfloat16, inp.torch.float32
    return [
        ("llama3.1_t32768_len24001", bf16, (LONG_T, H, KVH, D), [LONG_LEN], 0, 0.0),
        ("llama3.1_t32768_full", bf16, (LONG_T, H, KVH, D), [LONG_T], 0, 0.0),
        ("float32_t16384", f32, (16384, H, KVH, D), [16000], 0, 0.0),
        ("llama3.2_1b_d64_t20480", bf16, (20480, 32, 8, 64), [20000], 0, 0.0),
        ("window_softcap_bf16", bf16, (20480, H, KVH, D), [20480], 4096, 30.0),
        ("window_softcap_f32", f32, (8256, H, KVH, D), [8200], 1000, 30.0),
        ("batch_of_two", bf16, (20480, H, KVH, D), [20480, 9000], 0, 0.0),
        ("qwen2.5_7b_g7_t20000", bf16, (20000, 28, 4, D), [19999], 0, 0.0),
    ]


def _long_kernel_cases(torch, inp: Inputs) -> tuple[list, dict]:
    """The streamed kernel against its blocked plain version, then the
    ported kernels at long positions against theirs (bf16); attention
    cases with q scaled by LONG_Q_SCALE, held to the row-relative error."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import (
        attention_prefill_blocked_ref,
        prefill_kernel,
        ragged_paged_attention_ref,
    )
    from gridllm_torch.ops.kernels import F32_TOL, by_name
    from gridllm_torch.ops.kvcache import write_prefill

    cases, errs = [], {}
    bf16_tol = by_name("flash_prefill_streamed").rtol

    def q_of(*shape, dtype):
        return inp.randn(*shape, dtype=dtype) * LONG_Q_SCALE   # exact in bf16

    for name, dtype, (t, h, kvh, d), lens, window, cap in _streamed_cases(inp):
        check(prefill_kernel(t, d, torch.tensor([], dtype=dtype).element_size())
              == "flash_prefill_streamed", f"long: {name} does not route streamed")
        b = len(lens)
        q = q_of(b, t, h, d, dtype=dtype)
        k, v = inp.randn(b, t, kvh, d, dtype=dtype), inp.randn(b, t, kvh, d, dtype=dtype)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = ck.flash_prefill_streamed(q, k, v, sl, softcap=cap, window=window)
        want = attention_prefill_blocked_ref(q, k, v, sl, logit_softcap=cap, window=window)
        torch.cuda.synchronize()
        err = max(_max_err(got[i, :ln], want[i, :ln]) for i, ln in enumerate(lens))
        rel = max(_rel_err(got[i, :ln], want[i, :ln]) for i, ln in enumerate(lens))
        tol = bf16_tol if dtype == torch.bfloat16 else F32_TOL
        cases.append({"kernel": "flash_prefill_streamed", "case": name, "T": t, "H": h,
                      "KVH": kvh, "D": d, "seq_lens": lens, "window": window, "softcap": cap,
                      "dtype": str(dtype).split(".")[-1], "max_rel_err": rel,
                      "max_abs_err": err, "max_abs_want": float(want.abs().max())})
        check(rel <= tol, f"flash_prefill_streamed {name}: relative err {rel} > {tol}")
        if dtype == torch.bfloat16:
            errs["flash_prefill_streamed"] = max(errs.get("flash_prefill_streamed", 0.0), err)
        del q, k, v, got, want
        torch.cuda.empty_cache()

    # ragged_attention on a 512-entry table: decode (Td = 1) and verify
    # (Td = 5) groups at 24k-32k cached tokens, then a 1024-row chunk after
    # a 24000-token prefix
    bf16 = torch.bfloat16
    n_pages = S * LONG_MAXP
    kp = inp.randn(1, n_pages, PS, KVH, D, dtype=bf16)
    vp = inp.randn(1, n_pages, PS, KVH, D, dtype=bf16)
    table = torch.randperm(n_pages, generator=inp.gen, device="cuda").to(torch.int32)
    table = table.reshape(S, LONG_MAXP).contiguous()
    lengths = [24000, 24001, 26000, 28000, 30000, 31000, 32000, LONG_T - 5]
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for td in (1, 5):
        kw = dict(k_pages=kp, v_pages=vp, page_size=PS, q_group=q_of(S, td, H, D, dtype=bf16),
                  page_table=table, group_lengths=glens,
                  k_group=inp.randn(S, td, KVH, D, dtype=bf16),
                  v_group=inp.randn(S, td, KVH, D, dtype=bf16), layer=0)
        _, og = ck.ragged_attention(**kw)
        _, wg = ragged_paged_attention_ref(**kw)
        torch.cuda.synchronize()
        rel = _rel_err(og, wg)
        cases.append({"kernel": "ragged_attention", "case": f"group_td{td}_24k_to_32k",
                      "lengths": lengths, "max_rel_err": rel, "max_abs_err": _max_err(og, wg)})
        check(rel <= bf16_tol, f"ragged_attention long group Td={td}: relative err {rel}")
    c, start = 1024, 24000
    kw = dict(k_pages=kp, v_pages=vp, page_size=PS, q_chunk=q_of(1, c, H, D, dtype=bf16),
              chunk_row=table[0], chunk_start=start, chunk_total=start + 1000,
              k_chunk=inp.randn(c, KVH, D, dtype=bf16), v_chunk=inp.randn(c, KVH, D, dtype=bf16),
              layer=0)
    oc, _ = ck.ragged_attention(**kw)
    wc, _ = ragged_paged_attention_ref(**kw)
    torch.cuda.synchronize()
    rel = _rel_err(oc[:, :1000], wc[:, :1000])
    cases.append({"kernel": "ragged_attention", "case": "chunk_1024_after_24000",
                  "max_rel_err": rel, "max_abs_err": _max_err(oc[:, :1000], wc[:, :1000])})
    check(rel <= bf16_tol, f"ragged_attention chunk after 24000: relative err {rel}")
    del kp, vp, kw, oc, wc
    torch.cuda.empty_cache()

    # paged_write_chunk: 32768 rows of 32 layers into a pool of 32 x 1100
    # pages (2.3e9 elements per pool); the table puts the chunk's pages
    # high in the pool, so the last layer's offsets pass 2^31
    n_layers, n_pool = 32, 1100
    kp = torch.zeros((n_layers, n_pool, PS, KVH, D), dtype=bf16, device="cuda")
    vp = torch.zeros_like(kp)
    check(kp.numel() > 2 ** 31, "long: the write pool is not past 2^31 elements")
    row = (n_pool - 1 - torch.randperm(LONG_MAXP, generator=inp.gen, device="cuda")).to(torch.int32)
    length = LONG_T - 40
    kn = inp.randn(n_layers, LONG_T, KVH, D, dtype=bf16)
    vn = inp.randn(n_layers, LONG_T, KVH, D, dtype=bf16)
    ck.paged_write_chunk(kp, vp, kn, vn, row, 0, length, PS)
    want_k, want_v = write_prefill(torch.zeros_like(kp), torch.zeros_like(vp), kn, vn, row, 0,
                                   length, PS)
    torch.cuda.synchronize()
    # the kernel also writes the padded tail of the last page; the plain
    # version leaves it: clear it before comparing every other row
    last = length - 1
    kp[:, int(row[last // PS]), last % PS + 1:] = 0
    vp[:, int(row[last // PS]), last % PS + 1:] = 0
    exact = bool(torch.equal(kp, want_k) and torch.equal(vp, want_v))
    cases.append({"kernel": "paged_write_chunk", "case": "32768_rows_pool_past_2^31",
                  "pool_elements": kp.numel(), "exact": exact})
    check(exact, "paged_write_chunk: 32768 rows into the large pool differ")
    del kp, vp, kn, vn, want_k, want_v
    torch.cuda.empty_cache()
    return cases, errs


def _long_timing(torch, inp: Inputs) -> dict:
    """flash_prefill_streamed beside flash_prefill, SDPA and its plain
    version, bf16, on full buckets of 1024 to 32768 tokens (where the two
    kernels cross over on this card; the routing is the JAX package's), and
    at the serve path's shape (T = 32768, seq_len 24001)."""
    import torch.nn.functional as F

    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_blocked_ref

    bf16, out = torch.bfloat16, {}
    buckets = [(t, t) for t in (1024, 4096, 8192, 16384, LONG_T)]
    for t, ln in buckets + [(LONG_T, LONG_LEN)]:
        q = inp.randn(1, t, H, D, dtype=bf16)
        k, v = inp.randn(1, t, KVH, D, dtype=bf16), inp.randn(1, t, KVH, D, dtype=bf16)
        sl = torch.tensor([ln], dtype=torch.int32, device="cuda")
        b, op = bound_ms((2 * q.numel() + k.numel() + v.numel()) * 2,
                         4 * H * D * ln * (ln + 1) / 2)
        rec = {"shape": f"q[1,{t},{H},{D}] seq_len {ln} bf16",
               "ms": time_ms(torch, lambda: ck.flash_prefill_streamed(q, k, v, sl), iters=10),
               "plain_ms": time_ms(torch, lambda: attention_prefill_blocked_ref(q, k, v, sl),
                                   iters=1, warmup=1),
               "bound_ms": b, "bound_by": op}
        if ln == t:   # SDPA has no valid length: timed on full buckets only
            qt, kt, vt = (x[:, :ln].transpose(1, 2) for x in (q, k, v))
            rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
            rec["flash_prefill_ms"] = time_ms(torch, lambda: ck.flash_prefill(q, k, v, sl),
                                              iters=10 if t <= 8192 else 2, warmup=1)
            del qt, kt, vt
        out[f"T{t}_len{ln}"] = rec
        del q, k, v
        torch.cuda.empty_cache()
    # the kernels line: the serve path's shape, with SDPA on the valid rows
    main = dict(out[f"T{LONG_T}_len{LONG_LEN}"])
    q = inp.randn(1, LONG_LEN, H, D, dtype=bf16).transpose(1, 2)
    k = inp.randn(1, LONG_LEN, KVH, D, dtype=bf16).transpose(1, 2)
    v = inp.randn(1, LONG_LEN, KVH, D, dtype=bf16).transpose(1, 2)
    main["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=10)
    out["main_path"] = main
    del q, k, v
    torch.cuda.empty_cache()
    return out


def _long_model(torch) -> dict:
    """llama3.1:8b cut to 2 layers, full width, float32: a 10000-token
    prompt prefilled whole in the 16384 bucket (streamed), then 8 ragged
    decode steps, against the cache-free forward at the same positions,
    whose attention is the blocked plain version (at 10008 tokens the
    forward would route to the streamed kernel under test)."""
    import dataclasses
    from unittest import mock

    from gridllm_torch.models import llama
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.models.llama import Llama
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_blocked_ref
    from gridllm_torch.ops.kernels import F32_TOL
    from gridllm_torch.ops.kvcache import PagedKVCache

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    cfg = dataclasses.replace(get_config("llama3.1:8b"), num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    model = Llama(cfg, dtype=torch.float32, device="cuda").init_params(gen)
    n, steps, bucket = 10000, 8, 16384
    toks = torch.randint(0, cfg.vocab_size, (n + steps,), generator=gen, device="cuda",
                         dtype=torch.int32)
    ck.reset_launch_counts()
    with mock.patch.object(llama, "attention_prefill", attention_prefill_blocked_ref):
        full = model(toks[None])[0]                 # [n + 8, V]: 5 GB of logits
    want = full[n - 1:].clone()                     # positions n-1 .. n+7
    del full
    torch.cuda.empty_cache()
    forward_streamed = ck.launch_counts()["flash_prefill_streamed"]
    cache = PagedKVCache.create(cfg.num_layers, bucket // PS, PS, KVH, D, 1, bucket // PS,
                                dtype=torch.float32, device="cuda")
    row = torch.arange(bucket // PS, device="cuda", dtype=torch.int32)
    padded = torch.cat([toks[:n], torch.zeros(bucket - n, dtype=torch.int32, device="cuda")])
    ck.reset_launch_counts()
    logits, _ = model.prefill(padded, n, cache, 0, row)
    prefill_streamed = ck.launch_counts()["flash_prefill_streamed"]
    errs = [float((logits - want[0]).abs().max())]
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    for i in range(steps):
        logits, _ = model.decode_step(toks[n + i:n + i + 1], cache, active)
        errs.append(float((logits[0] - want[i + 1]).abs().max()))
    torch.cuda.synchronize()
    check(forward_streamed == 0 and prefill_streamed == cfg.num_layers,
          f"long model: streamed launches forward {forward_streamed}, prefill {prefill_streamed}")
    check(max(errs) <= F32_TOL, f"long model: paged path differs from forward by {max(errs)}")
    del model, cache, want
    torch.cuda.empty_cache()
    return {"config": "llama3.1:8b, 2 layers, float32", "prompt": n, "bucket": bucket,
            "decode_steps": steps, "logit_rows_compared": len(errs), "max_abs_err": max(errs),
            "streamed_launches_forward_prefill": [forward_streamed, prefill_streamed]}


def _long_serve(torch) -> dict:
    """llama3.1:8b bf16 serving a 24001-token prompt whole (32768 bucket,
    flash_prefill_streamed) beside a short request, then its warm repeat
    (the 24000 cached tokens, then one 32768-row mixed-step chunk). The
    launch counters start at 0 before the first request."""
    import random

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.ops import cuda_kernels as ck

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = random.Random(SEED + 4)
    long_prompt = _prompt(rng, LONG_LEN - 1)    # + BOS: 24001 tokens
    short = _prompt(rng, 40)
    t0 = time.perf_counter()
    srv = Served(torch, InferenceEngine(EngineConfig(**LONG_ENGINE), device="cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    engine = srv.engine
    check(engine._chunk_len == LONG_T and LONG_T in engine._buckets, "long: engine config")
    draft_s: list[float] = []
    draft = engine._drafter.draft

    def timed_draft(ids, k):
        t = time.perf_counter()
        out = draft(ids, k)
        draft_s.append(time.perf_counter() - t)
        return out

    engine._drafter.draft = timed_draft
    vocab, slots, k1 = srv.vocab, engine.config.max_slots, engine.config.spec_k + 1
    engine.start()
    ck.reset_launch_counts()
    n_long, n_short = 32, 32
    (cold, other), wall = srv.run([(long_prompt, n_long), (short, n_short)])
    check(cold.prompt_eval_count == LONG_LEN and cold.cached_tokens == 0,
          f"long: prompt of {cold.prompt_eval_count} tokens, {cold.cached_tokens} cached")
    cold_launches = ck.launch_counts()
    check(cold_launches["flash_prefill_streamed"] == engine.cfg.num_layers,
          f"long: {cold_launches['flash_prefill_streamed']} streamed launches for one prefill")
    steps_cold = engine.spec_stats["steps"]
    (warm,), wall_warm = srv.run([(long_prompt, n_long)])
    check(warm.cached_tokens == (LONG_LEN - 1) // PS * PS,
          f"long: the warm repeat hit {warm.cached_tokens} cached tokens")
    launches = _path_launches(ck, "long_spec_ragged", srv)
    check(launches["flash_prefill_streamed"] == engine.cfg.num_layers,
          "long: the warm repeat launched the streamed kernel")
    matching = 0
    for a, b in zip(cold.token_ids, warm.token_ids):
        if a != b:
            break
        matching += 1
    summary = srv.summary([cold, other], wall, {(vocab,), (slots, vocab), (slots, k1, vocab)})
    steps = engine.spec_stats["steps"]
    decode_s = cold.eval_duration_ns / 1e9
    out = {
        "model": "llama3.1:8b", "dtype": "bfloat16", "engine": LONG_ENGINE, "load_s": load_s,
        "long_prompt_tokens": cold.prompt_eval_count,
        "long_ttft_ms": cold.prompt_eval_duration_ns / 1e6,
        "short_ttft_ms": other.prompt_eval_duration_ns / 1e6,
        "long_decode_tokens_per_s": max(cold.eval_count - 1, 0) / decode_s if decode_s else None,
        "long_tokens": cold.eval_count, "decode_context_tokens": LONG_LEN + cold.eval_count,
        "verify_steps": steps, "verify_steps_cold": steps_cold,
        "drafter_host_ms_per_verify_step": sum(draft_s) * 1e3 / max(steps, 1),
        "drafter_calls": len(draft_s),
        "warm_cached_tokens": warm.cached_tokens,
        "warm_ttft_ms": warm.prompt_eval_duration_ns / 1e6, "warm_wall_s": wall_warm,
        "warm_tokens_matching_cold": f"{matching}/{len(warm.token_ids)}",
        "launches_cold": cold_launches, "launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        **{k: summary[k] for k in ("tokens", "wall_s", "tokens_per_s", "logit_shapes")},
    }
    _free(torch, srv)
    return out


def phase_long(torch) -> dict:
    """Long-context serving on llama3.1:8b: kernel cases, timing, the
    2-layer float32 cut, then the engine (see the module docstring)."""
    inp = Inputs(torch, SEED + 5)
    cases, errs = _long_kernel_cases(torch, inp)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "long_kernel_cases.json").write_text(json.dumps(cases, indent=1))
    timing = _long_timing(torch, inp)
    model = _long_model(torch)
    serve = _long_serve(torch)
    return {"phase": "long", "card": card_line(), "cases": len(cases),
            "max_abs_err_bf16": errs, "timing": timing,
            "kernels": {"flash_prefill_streamed": timing["main_path"]},
            "model": model, "serve": serve,
            "launches": {"flash_prefill_streamed": serve["launches"]["flash_prefill_streamed"]}}


# ---------------------------------------------------------------------------
# tree: draft-model tree speculation and ragged_attention's tree leg
# ---------------------------------------------------------------------------

# llama3.2:1b attention widths: the draft model's ragged launches
DRAFT_H, DRAFT_KVH, DRAFT_D = 32, 8, 64


def _tree_operands(parents):
    from gridllm_torch.ops.spec import tree_ancestor_bits, tree_ancestor_mask, tree_depths

    return tree_depths(parents), tree_ancestor_mask(parents), tree_ancestor_bits(parents)


def _tree_kernel_cases(torch, inp: Inputs) -> tuple[list, float]:
    """The tree leg against its plain version (ragged_paged_attention_ref
    with tree_pos/tree_mask), q scaled by LONG_Q_SCALE and held to the
    row-relative error: bf16 and float32 compute, fp and int8 pools,
    D = 128 and 64, topologies (4, 2) (the default), (4, 1) (a pure chain,
    also held to the causal group's output), (4, 8) and (16, 16) (32 nodes,
    bit 31 set), a window of 4096 with softcap 30; eight slots from 0 to
    32,700 cached tokens on a 512-entry table."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import ragged_paged_attention_ref
    from gridllm_torch.ops.kernels import F32_TOL, by_name
    from gridllm_torch.ops.kvcache import QuantPages
    from gridllm_torch.ops.spec import tree_topology

    lengths = [0, 5, 63, 64, 1024, 4000, 24000, 32700]
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    table = torch.randperm(S * LONG_MAXP, generator=inp.gen, device="cuda").to(torch.int32)
    table = table.reshape(S, LONG_MAXP).contiguous()
    topologies = {"k4_w2": (4, 2), "k4_w1_chain": (4, 1), "k4_w8": (4, 8), "k16_w16": (16, 16)}
    cases, worst_abs = [], 0.0
    for d, h, kvh in ((D, H, KVH), (DRAFT_D, DRAFT_H, DRAFT_KVH)):
        shape = (1, S * LONG_MAXP, PS, kvh, d)
        for dtype, tol in ((torch.bfloat16, by_name("ragged_attention").rtol),
                           (torch.float32, F32_TOL)):
            dname = str(dtype).split(".")[-1]
            fp = (inp.randn(*shape, dtype=dtype), inp.randn(*shape, dtype=dtype))
            pools = {"fp": fp}
            if dtype == torch.bfloat16:   # one int8 pool serves both compute dtypes
                quant = _quant_pools(torch, inp, 1, S * LONG_MAXP, d=d)
            pools["int8"] = quant
            for pool_name, (kp, vp) in pools.items():
                scales, kd, vd = {}, kp, vp
                if isinstance(kp, QuantPages):
                    scales, kd, vd = dict(k_scale=kp.scale, v_scale=vp.scale), kp.data, vp.data
                for topo, (k, width) in topologies.items():
                    parents = tree_topology(k, width)
                    n = len(parents)
                    depths, anc, bits = _tree_operands(parents)
                    kw = dict(q_group=inp.randn(S, n, h, d, dtype=dtype) * LONG_Q_SCALE,
                              page_table=table, group_lengths=glens,
                              k_group=inp.randn(S, n, kvh, d, dtype=dtype),
                              v_group=inp.randn(S, n, kvh, d, dtype=dtype))
                    windows = ((0, 0.0), (4096, 30.0)) if topo == "k4_w2" else ((0, 0.0),)
                    for window, cap in windows:
                        _, og = ck.ragged_attention(kd, vd, PS, layer=0, softcap=cap,
                                                    window=window, tree_pos=depths,
                                                    tree_bits=bits, **scales, **kw)
                        _, wg = ragged_paged_attention_ref(
                            kp, vp, PS, layer=0, logit_softcap=cap, window=window,
                            tree_pos=depths, tree_mask=anc, **kw)
                        torch.cuda.synchronize()
                        rel, err = _rel_err(og, wg), _max_err(og, wg)
                        case = {"kernel": "ragged_attention.tree", "dtype": dname,
                                "pool": pool_name, "D": d, "topology": topo, "nodes": n,
                                "window": window, "softcap": cap, "max_rel_err": rel,
                                "max_abs_err": err}
                        name = f"{dname} {pool_name} D={d} {topo} window={window}"
                        check(rel <= tol,
                              f"ragged_attention tree {name}: relative err {rel} > {tol}")
                        if topo == "k4_w1_chain":   # the causal group on the same inputs
                            _, chain = ck.ragged_attention(kd, vd, PS, layer=0, softcap=cap,
                                                           window=window, **scales, **kw)
                            torch.cuda.synchronize()
                            case["chain_max_abs_diff"] = _max_err(og, chain)
                            check(_rel_err(og, chain) <= tol,
                                  f"ragged_attention tree {name}: differs from the causal group")
                        cases.append(case)
                        if dtype == torch.bfloat16:
                            worst_abs = max(worst_abs, err)
                        del og, wg
                    del kw
            del fp, pools, kp, vp, kd, vd
            torch.cuda.empty_cache()
        del quant
        torch.cuda.empty_cache()
    return cases, worst_abs


def _group_work(lengths, n, h, kvh, d, visible, itemsize=2):
    """(bytes, flops) a group launch needs: every cached K/V row of every
    slot read once, the fresh K/V, q and the output once; two products of
    2 flops per (query head, visible key, dim). visible[i]: the fresh
    columns node i sees."""
    nbytes = (sum(lengths) * kvh * d * 2 + len(lengths) * n * kvh * d * 2
              + 2 * len(lengths) * n * h * d) * itemsize
    keys = sum(ln * n + sum(visible) for ln in lengths)
    return nbytes, 4 * h * d * keys


def _tree_timing(torch, inp: Inputs) -> dict:
    """bf16 on the fp pool: the tree leg at S = 8, N = 6 (the default
    topology) after 1,024 cached tokens, beside the causal group at Td = 5
    and Td = 6 on the same inputs (timed in turns: chain, tree, tree,
    chain), and the draft model's Td = 64 catch-up group at D = 64."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import ragged_paged_attention_ref
    from gridllm_torch.ops.spec import tree_topology

    bf16 = torch.bfloat16
    kp, vp = inp.pools(1, bf16)
    lengths = [1024] * S
    table = inp.page_table(lengths, extra=64)
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    parents = tree_topology(4, 2)
    n = len(parents)
    depths, anc, bits = _tree_operands(parents)
    kw = dict(k_pages=kp, v_pages=vp, page_size=PS, page_table=table, group_lengths=glens,
              q_group=inp.randn(S, n, H, D, dtype=bf16),
              k_group=inp.randn(S, n, KVH, D, dtype=bf16),
              v_group=inp.randn(S, n, KVH, D, dtype=bf16), layer=0)
    kw5 = {**kw, **{k: kw[k][:, :5].contiguous() for k in ("q_group", "k_group", "v_group")}}
    tree = dict(tree_pos=depths, tree_bits=bits)

    def run_tree():
        ck.ragged_attention(**kw, **tree)

    def run_chain6():
        ck.ragged_attention(**kw)

    runs = {"chain_td6": [time_ms(torch, run_chain6)], "tree": []}
    runs["tree"] += [time_ms(torch, run_tree), time_ms(torch, run_tree)]
    runs["chain_td6"].append(time_ms(torch, run_chain6))
    b, op = bound_ms(*_group_work(lengths, n, H, KVH, D, anc.sum(axis=1).tolist()))
    b6, op6 = bound_ms(*_group_work(lengths, n, H, KVH, D, list(range(1, n + 1))))
    b5, op5 = bound_ms(*_group_work(lengths, 5, H, KVH, D, list(range(1, 6))))
    out = {
        "shape": f"tree group S={S} N={n} (k=4, width 2) context=1024 bf16",
        "card": card_line(),
        "ms": statistics.mean(runs["tree"]), "runs_ms": runs,
        "plain_ms": time_ms(torch, lambda: ragged_paged_attention_ref(
            **kw, tree_pos=depths, tree_mask=anc), iters=3),
        "library_ms": None, "bound_ms": b, "bound_by": op,
        "chain_td6_ms": statistics.mean(runs["chain_td6"]), "chain_td6_bound_ms": b6,
        "chain_td5_ms": time_ms(torch, lambda: ck.ragged_attention(**kw5)),
        "device_ms": device_ms(torch, run_tree), "chain_td6_device_ms": device_ms(torch, run_chain6),
        "chain_td5_bound_ms": b5, "chain_td5_bound_by": op5,
    }
    del kp, vp, kw, kw5
    torch.cuda.empty_cache()
    # the draft model's catch-up chunk: Td = 64 at llama3.2:1b widths
    shape = (1, S * MAXP, PS, DRAFT_KVH, DRAFT_D)
    kp, vp = inp.randn(*shape, dtype=bf16), inp.randn(*shape, dtype=bf16)
    td = 64
    ikw = dict(q_group=inp.randn(S, td, DRAFT_H, DRAFT_D, dtype=bf16), page_table=table,
               group_lengths=glens, k_group=inp.randn(S, td, DRAFT_KVH, DRAFT_D, dtype=bf16),
               v_group=inp.randn(S, td, DRAFT_KVH, DRAFT_D, dtype=bf16), layer=0)
    bi, opi = bound_ms(*_group_work(lengths, td, DRAFT_H, DRAFT_KVH, DRAFT_D,
                                    list(range(1, td + 1))))
    out["draft_ingest"] = {
        "shape": f"chain group S={S} Td={td} context=1024 D={DRAFT_D} bf16",
        "ms": time_ms(torch, lambda: ck.ragged_attention(kp, vp, PS, **ikw)),
        "device_ms": device_ms(torch, lambda: ck.ragged_attention(kp, vp, PS, **ikw)),
        "plain_ms": time_ms(torch, lambda: ragged_paged_attention_ref(kp, vp, PS, **ikw),
                            iters=3),
        "library_ms": None, "bound_ms": bi, "bound_by": opi,
    }
    del kp, vp, ikw
    torch.cuda.empty_cache()
    return out


def _tree_model(torch) -> dict:
    """llama3:8b cut to 2 layers, full width, float32, on an fp pool and on
    an int8 pool. After a prompt, a hand-made tree (default topology): a
    chain head the target does not pick and a sibling that it does. The
    tree verify through the kernels, spec_accept_tree and commit_tree_path
    against the same tokens fed one at a time: the accepted nodes' logits
    within 1e-3 and, on the fp pool, the committed rows within 1e-5; on the
    int8 pool the moved rows equal the optimistic write bit for bit. Then a
    second tree whose chain is the greedy continuation, read over the
    compacted rows. The fp reference is decode steps; the int8 reference is
    chain verify steps of the accepted tokens, which, as the tree verify,
    attend a step's own tokens unquantized (a decode step reads the token
    before it back from the int8 pool, a difference of the int8 format, not
    of the tree)."""
    import dataclasses

    from gridllm_torch.models.configs import get_config
    from gridllm_torch.models.llama import Llama
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.kernels import F32_TOL
    from gridllm_torch.ops.kvcache import (
        PagedKVCache,
        QuantPages,
        commit_tree_path,
        rollback_to_length,
    )
    from gridllm_torch.ops.sampling import SamplingParams, spec_accept_tree
    from gridllm_torch.ops.spec import tree_topology

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3:8b"), num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    model = Llama(cfg, dtype=torch.float32, device="cuda").init_params(gen)
    vocab, n0 = cfg.vocab_size, 200
    prompt = torch.randint(0, vocab, (n0,), generator=gen, device="cuda", dtype=torch.int32)
    parents = tree_topology(4, 2)
    depths, anc, _ = _tree_operands(parents)
    row = torch.arange(8, dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.bool, device="cuda")

    def cache_of(kv_int8):
        cache = PagedKVCache.create(cfg.num_layers, 8, PS, KVH, D, 1, 8, dtype=torch.float32,
                                    device="cuda", kv_int8=kv_int8)
        logits, _ = model.prefill(torch.cat([prompt, prompt[:56] * 0]), n0, cache, 0, row)
        return cache, int(torch.argmax(logits))

    def pool_rows(cache, lo, hi):   # [L, rows, KVH, D] of positions lo..hi-1 (page 3)
        if isinstance(cache.k, QuantPages):
            return [cache.k.data[:, 3, lo - 192:hi - 192].clone(),
                    cache.k.scale[:, 3, lo - 192:hi - 192].clone(),
                    cache.v.data[:, 3, lo - 192:hi - 192].clone(),
                    cache.v.scale[:, 3, lo - 192:hi - 192].clone()]
        return [cache.k[:, 3, lo - 192:hi - 192].clone(), cache.v[:, 3, lo - 192:hi - 192].clone()]

    def accept(logits, cand):
        sp = SamplingParams.defaults(1, "cuda")
        sp.temperature.zero_()
        sp.repeat_penalty.fill_(1.0)
        valid = torch.ones((1, len(parents)), dtype=torch.bool, device="cuda")
        return spec_accept_tree(logits, cand, parents, valid, sp,
                                torch.zeros((1, vocab), dtype=torch.int32, device="cuda"),
                                torch.zeros((1, 8), dtype=torch.int32, device="cuda"),
                                torch.zeros(1, dtype=torch.int32, device="cuda"), one, vocab)

    out = {}
    for pool in ("fp", "int8"):
        quant = pool == "int8"
        seq, root = cache_of(quant)
        toks, seq_logits = [root], []
        for _ in range(6):   # greedy continuation through decode steps
            logits, _ = model.decode_step(torch.tensor([toks[-1]], dtype=torch.int32,
                                                       device="cuda"), seq, one)
            seq_logits.append(logits[0])
            toks.append(int(torch.argmax(logits[0])))
        if quant:   # the accepted tokens as chain verify steps: 2 rows, then 5
            seq, _ = cache_of(quant)
            seq_logits = []
            for chain in (toks[0:2], toks[2:7]):
                logits, _ = model.verify_step(torch.tensor([chain], dtype=torch.int32,
                                                           device="cuda"), seq, one)
                seq_logits += list(logits[0])
                rollback_to_length(seq, seq.lengths + len(chain))
        cache, root2 = cache_of(quant)
        check(root2 == root, "tree model: prefill not deterministic")
        # tree 1: the chain head misses (pick + 1), the sibling is the pick
        pick = toks[1]
        cand = torch.tensor([[root, (pick + 1) % vocab, 11, 12, 13, pick]], dtype=torch.int32,
                            device="cuda")
        ck.reset_launch_counts()
        logits, _ = model.verify_step(cand, cache, one, tree_pos=depths, tree_mask=anc)
        launches = ck.launch_counts()
        optimistic = pool_rows(cache, n0 + 5, n0 + 6)
        emitted, path, n_emit, _ = accept(logits, cand)
        check(n_emit.tolist() == [2] and path[0, :2].tolist() == [5, 0]
              and emitted[:2, 0].tolist() == toks[1:3],
              f"tree model {pool}: accepted {emitted[:, 0].tolist()} path {path.tolist()}")
        commit_tree_path(cache, path, one)
        rollback_to_length(cache, cache.lengths + n_emit)
        errs = [_max_err(logits[0, 0], seq_logits[0]), _max_err(logits[0, 5], seq_logits[1])]
        moved = pool_rows(cache, n0 + 1, n0 + 2)
        if quant:
            check(all(torch.equal(a, b) for a, b in zip(moved, optimistic)),
                  "tree model int8: the moved row differs from the optimistic write")
            row_err = None
        else:
            row_err = max(_max_err(a, b) for a, b in zip(pool_rows(cache, n0, n0 + 2),
                                                         pool_rows(seq, n0, n0 + 2)))
            check(row_err <= 1e-5, f"tree model fp: committed rows differ by {row_err}")
        # tree 2 over the compacted rows: the chain is the greedy continuation
        cand = torch.tensor([[toks[2], *toks[3:7], (toks[3] + 7) % vocab]], dtype=torch.int32,
                            device="cuda")
        logits, _ = model.verify_step(cand, cache, one, tree_pos=depths, tree_mask=anc)
        emitted, path, n_emit, _ = accept(logits, cand)
        check(n_emit.tolist() == [5] and path[0].tolist() == [1, 2, 3, 4, 0, 0],
              f"tree model {pool}: second step accepted {n_emit.tolist()}, path {path.tolist()}")
        torch.cuda.synchronize()
        errs += [_max_err(logits[0, j], seq_logits[2 + j]) for j in range(4)]
        check(max(errs) <= F32_TOL, f"tree model {pool}: logits differ by {max(errs)}")
        check(launches["ragged_attention.tree"] == cfg.num_layers,
              f"tree model {pool}: verify launches {launches}")
        out[pool] = {"accepted_logit_rows": len(errs), "max_abs_err": max(errs),
                     "committed_rows_max_abs_err": row_err,
                     "moved_rows_bit_equal_to_optimistic_write": quant or None,
                     "verify_launches": launches}
        del seq, cache, logits
    del model
    torch.cuda.empty_cache()
    return {"config": "llama3:8b, 2 layers, float32", **out}


def _tree_draft_checkpoint(torch, path: str) -> int:
    """The draft's random weights (llama3.2:1b, bf16, seed 0: the weights a
    draft model without a checkpoint gets) written as a checkpoint."""
    from gridllm_torch.engine import loader
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.models.llama import Llama

    draft = Llama(get_config("llama3.2:1b"), dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    draft.init_params(gen)
    n = loader.save_checkpoint(draft, draft.cfg, path, torch.bfloat16)
    del draft
    torch.cuda.empty_cache()
    return n


def _tree_one_stream(engine) -> list[int]:
    """One greedy request, alone on the engine, on a prompt no earlier
    request shared a page with."""
    import random

    from gridllm_torch.engine import GenerationRequest

    res = engine.generate(GenerationRequest(
        id="draft-source", prompt=_prompt(random.Random(SEED + 13), 300),
        options={"temperature": 0.0, "num_predict": 48}))
    check(res.done_reason in ("length", "stop") and res.token_ids,
          f"tree serve: the draft-source request finished {res.done_reason!r} ({res.error})")
    return res.token_ids


def _tree_serve(torch) -> dict:
    """llama3:8b bf16 with draft_model="llama3.2:1b" (random weights from
    seed 0; the draft's read from a checkpoint of them, draft_checkpoint)
    behind the runner thread: the serve phase's eight concurrent requests,
    then a prefix-cache repeat; launch counts from 0 just before the first
    and read just after the last. Then one request's stream against an
    engine whose draft weights were made in memory."""
    import shutil
    import tempfile

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.spec import DraftModelDrafter

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="gridllm-draft-")
    try:
        draft_bytes = _tree_draft_checkpoint(torch, tmp)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        srv = Served(torch, InferenceEngine(EngineConfig(
            model="llama3:8b", draft_model="llama3.2:1b", draft_checkpoint=tmp),
            device="cuda"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    engine = srv.engine
    check(isinstance(engine._drafter, DraftModelDrafter), "tree serve: no draft model")
    vocab, slots = srv.vocab, engine.config.max_slots
    n = engine.config.spec_k + engine.config.spec_tree_width
    _, short, _, batch_a = _serve_prompts()
    engine.start()
    ck.reset_launch_counts()
    res, wall = srv.run(batch_a)
    (warm,), wall_warm = srv.run([(short[2], 64)])
    counts = ck.launch_counts()
    check(warm.cached_tokens > 0, "tree serve: the repeat missed the prefix cache")
    stats = engine.batch_state()["specDecode"]
    layers, steps = engine.cfg.num_layers, stats["steps"]
    tree = counts["ragged_attention.tree"]
    draft = counts["ragged_attention"] - tree
    check(steps > 0 and tree == layers * steps,
          f"tree serve: {tree} tree launches for {steps} verify steps of {layers} layers")
    check(draft > 0, f"tree serve: the draft model launched no ragged attention: {counts}")
    never = ("paged_decode", "prefix_chunk", "flash_prefill_streamed")
    check(all(counts[k] == 0 for k in never), f"tree serve: a per-phase kernel launched: {counts}")
    out = {
        **srv.summary(res, wall, {(vocab,), (slots, vocab), (slots, n, vocab)}),
        "model": "llama3:8b", "draft_model": "llama3.2:1b", "dtype": "bfloat16",
        "tree": f"k={engine.config.spec_k} width={engine.config.spec_tree_width} nodes={n}",
        "load_s": load_s, "warm_cached_tokens": warm.cached_tokens, "warm_wall_s": wall_warm,
        "draft_ms_per_verify_step": stats["draft_ns"] / 1e6 / max(steps, 1),
        "tree_launches": tree, "draft_and_mixed_ragged_launches": draft,
        "tree_launches_per_verify_step": tree / max(steps, 1), "launches": counts,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "draft_checkpoint_bytes": draft_bytes,
    }
    from_file = _tree_one_stream(engine)
    _free(torch, srv)
    in_memory = InferenceEngine(EngineConfig(model="llama3:8b", draft_model="llama3.2:1b"),
                                device="cuda")
    check(_tree_one_stream(in_memory) == from_file,
          "tree serve: the stream with the draft from its checkpoint differs from the "
          "stream with the same draft weights made in memory")
    out["draft_checkpoint_stream_equals_in_memory"] = True
    del in_memory
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tree_parity(torch) -> dict:
    """Float32 greedy streams of llama3.2:1b drafted by itself (identical
    random weights, so deep accepted paths), each held to spec decode off
    in the same attention mode and pool: ragged on, ragged off, ragged on
    with kv_int8. Acceptance must be > 0 in every tree run."""
    import random

    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine

    prompt = _prompt(random.Random(SEED + 9), 300)
    opts = {"temperature": 0.0, "num_predict": 48}
    runs = {}
    for name, extra in (("ragged_on", {}), ("ragged_off", {"ragged_attention": False}),
                        ("ragged_on_int8", {"kv_int8": True})):
        streams = {}
        for spec in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            cfg = EngineConfig(model="llama3.2:1b", dtype="float32", spec_decode=spec,
                               draft_model="llama3.2:1b" if spec else None, **extra)
            engine = InferenceEngine(cfg, device="cuda")
            res = engine.generate(GenerationRequest(id=name, prompt=prompt, options=dict(opts)))
            check(res.done_reason in ("length", "stop") and res.token_ids,
                  f"tree parity {name}: finished {res.done_reason!r} ({res.error})")
            streams[spec] = res.token_ids
            if spec:
                runs[name] = {"tokens": len(res.token_ids), "proposed": res.spec_proposed,
                              "accepted": res.spec_accepted,
                              "verify_steps": engine.spec_stats["steps"],
                              "acceptance": res.spec_accepted / max(res.spec_proposed, 1)}
            del engine
        check(streams[True] == streams[False], f"tree parity {name}: stream differs from spec off")
        check(runs[name]["accepted"] > 0, f"tree parity {name}: no draft accepted")
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": "llama3.2:1b", "draft_model": "llama3.2:1b", "dtype": "float32",
            "streams_identical_to_spec_off": True, "runs": runs}


def phase_tree(torch) -> dict:
    """Draft-model tree speculation: the tree leg's kernel cases and
    timing, the 2-layer float32 tree commit check, llama3:8b serving with a
    llama3.2:1b draft, and float32 self-draft parity (see the module
    docstring)."""
    inp = Inputs(torch, SEED + 9)
    cases, worst_abs = _tree_kernel_cases(torch, inp)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "tree_kernel_cases.json").write_text(json.dumps(cases, indent=1))
    timing = _tree_timing(torch, inp)
    model = _tree_model(torch)
    serve = _tree_serve(torch)
    parity = _tree_parity(torch)
    return {"phase": "tree", "card": card_line(), "cases": len(cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases), "max_abs_err_bf16": worst_abs,
            "timing": timing, "model": model, "serve": serve, "parity": parity,
            "launches": serve["tree_launches"]}


# ---------------------------------------------------------------------------
# kvx: KV movement between workers and the host KV tier
# ---------------------------------------------------------------------------

KVX_PROMPT_BYTES = 1500   # 1,501 byte tokens: 23 full pages of 64 move
KVX_TOKENS = 64
KVX_DRAIN_TOKENS = 160    # long enough that the drain lands mid-decode
KVX_DRAIN_AFTER = 16      # snapshot tokens before the drain
KVX_F32_LAYERS = 8        # the float32 cut: two engines and their pools fit
KVX_TIER_PAGES = 48       # the host-tier engine's pool: one long prompt evicts


class _KvxStandIn(_StandIn):
    """The stand-in scheduler plus the two handoffs KV movement adds, as the
    JAX package's scheduler makes them: `job:handoff` (ok) reassigns the job
    to the planned decode worker with disaggPhase "decode", and `job:drain`
    (migrated) reassigns it to the peer that took the pages, with the last
    snapshot and the chars already delivered as metadata.resume."""

    async def start(self):
        from gridllm_torch.bus.base import CH_JOB_DRAIN, CH_JOB_HANDOFF

        await super().start()
        self.handoffs: dict[str, dict] = {}
        self.drains: dict[str, dict] = {}
        self.t_handoff: dict[str, float] = {}
        self.tasks: list = []
        await self.bus.subscribe(CH_JOB_HANDOFF, self._on_handoff)
        await self.bus.subscribe(CH_JOB_DRAIN, self._on_drain)

    async def _on_handoff(self, _ch, raw):
        msg = json.loads(raw)
        self.handoffs[msg["jobId"]] = msg
        job = self.jobs.get(msg["jobId"])
        if job is None or not msg["ok"]:
            return   # not ok: the prefill worker serves the job itself
        req = job.req
        req.metadata = {**(req.metadata or {}), "disaggPhase": "decode",
                        "kvxTokens": int(msg.get("tokens") or 0)}
        self.t_handoff[req.id] = time.perf_counter()
        await self._reassign(msg["toWorker"], job)

    async def _on_drain(self, _ch, raw):
        import asyncio

        msg = json.loads(raw)
        self.drains[msg["jobId"]] = msg
        if msg["jobId"] in self.jobs:
            # off this handler: the bus's flush waits for every handler
            self.tasks.append(asyncio.ensure_future(self._resume_drained(msg)))

    async def _resume_drained(self, msg):
        job = self.jobs[msg["jobId"]]
        await self.bus.flush()   # frames published before the drain arrive first
        snap = msg.get("snapshot") or {}
        req = job.req
        md = {k: v for k, v in (req.metadata or {}).items() if not k.startswith("disagg")}
        md["resume"] = {"tokens": snap.get("tokens", []), "seed": snap.get("seed"),
                        "sentChars": len(job.text)}
        req.metadata = md
        if not (msg["migrated"] and msg["toWorker"]):
            job.result.set_exception(SmokeFailure(
                f"kvx: the drain did not migrate {msg['jobId']}: {msg}"))
            return
        await self._reassign(msg["toWorker"], job)

    async def _reassign(self, worker_id, job):
        """Assign the job again, to `worker_id`; the caller keeps awaiting the
        job's result future (the one submit made)."""
        from gridllm_torch.bus.base import worker_job_channel
        from gridllm_torch.utils.types import JobAssignment

        assignment = JobAssignment(jobId=job.req.id, workerId=worker_id, request=job.req)
        await self.bus.publish(worker_job_channel(worker_id), json.dumps(
            {"type": "job_assignment", "job": assignment.model_dump()}))


class _Timed:
    """Wall time and bytes of an engine method's calls (export, import), the
    device synchronized at each call's end, until restore()."""

    def __init__(self, torch, engine, name, nbytes):
        self.engine, self.name, self.calls = engine, name, []
        fn = getattr(engine, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0, nbytes(args, out)))
            return out

        setattr(engine, name, timed)

    def restore(self) -> None:
        delattr(self.engine, self.name)   # the class's method again

    def gbps(self) -> float:
        s = sum(t for t, _ in self.calls)
        return sum(b for _, b in self.calls) / s / 1e9 if s else 0.0

    def ms_each(self) -> float:
        return sum(t for t, _ in self.calls) / max(len(self.calls), 1) * 1e3


def _kvx_engine(torch, **kw):
    from gridllm_torch.engine import EngineConfig, InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(**{"model": WORKER_MODEL, **kw}), device="cuda")
    _printable_head(torch, engine)
    return engine


def _kvx_evict(engine, tokens) -> int:
    """Drop the cached pages of `tokens` from an engine's prefix cache (no
    spill), so the next import or admission starts from nothing."""
    with engine._alloc_lock:
        pages, _ = engine.alloc.pin_prefix(tokens)
        engine.alloc.unpin_pages(pages)
        return engine.alloc.evict_cached(pages)


def _kvx_pages(engine, tokens):
    """The cached prefix pages of `tokens` as the wire carries them."""
    out = engine.export_prefix_pages(tokens)
    check(out is not None, "kvx: no cached prefix to read back")
    return out


async def _kvx_disagg(torch, pre, dec, prompt, tag, path) -> dict:
    """One disaggregated job: the prompt served whole on the decode worker's
    engine (unified), its pages dropped there, then the same job assigned to
    a prefill-role worker with the decode worker planned: export_only
    prefill, export, transfer over `path` ("bus" or "http", the decode
    worker's /kvx/ route), import, handoff, decode. The imported pages must
    equal the exporter's bit for bit; returns the streams, the last-token
    admission logits of both runs and the readings."""
    import asyncio
    import os

    from gridllm_torch.bus import InMemoryBus
    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker.main import start_health_port
    from gridllm_torch.worker.service import WorkerService

    results = _capture_results(dec)
    srv = Served(torch, dec)
    bus = InMemoryBus()
    await bus.connect()
    standin = _KvxStandIn(bus)
    await standin.start()
    w_pre = WorkerService(bus, {WORKER_MODEL: pre}, WorkerConfig(
        worker_id=f"kvx-{tag}-prefill", role="prefill", heartbeat_interval_ms=1000),
        stream_flush_ms=20)
    w_dec = WorkerService(bus, {WORKER_MODEL: dec}, WorkerConfig(
        worker_id=f"kvx-{tag}-decode", role="decode", heartbeat_interval_ms=1000),
        stream_flush_ms=20)
    http = None
    os.environ["GRIDLLM_KVX_HTTP_BYTES"] = "1" if path == "http" else "0"
    os.environ["GRIDLLM_KVX_TIMEOUT_MS"] = "120000"
    exported = _Timed(torch, pre, "export_prefix_pages",
                      lambda a, out: out["k"].nbytes + out["v"].nbytes if out else 0)
    imported = _Timed(torch, dec, "import_prefix_pages",
                      lambda a, out: a[1].nbytes + a[2].nbytes)
    try:
        for w in (w_pre, w_dec):
            await w.start()
        addr = ""
        if path == "http":
            http = await start_health_port(w_dec, "127.0.0.1", 0)
            addr = "127.0.0.1:%d" % http.addresses[0][1]
        # the decode engine starts cold on the prompt: unified serving first,
        # then its pages dropped, so the disaggregated decode reads only
        # imported pages
        ids = dec.tokenizer.encode(prompt, add_bos=True)
        _kvx_evict(dec, ids)
        uni = await standin.submit(w_dec.worker_id, _worker_request(f"{tag}-uni", KVX_TOKENS,
                                                                      prompt))
        srv.admissions = []
        uni_res = await asyncio.wait_for(uni.result, 600)
        check(uni_res.success and results[f"{tag}-uni"].cached_tokens == 0,
              f"kvx {tag}: unified run {uni_res.error}")
        check(results[f"{tag}-uni"].context[:len(ids)] == ids, f"kvx {tag}: prompt tokens")
        uni_logits = srv.admissions[-1][1]
        _kvx_evict(dec, ids)
        req = _worker_request(f"{tag}-dis", KVX_TOKENS, prompt)
        req.metadata["disagg"] = {"decodeWorkerId": w_dec.worker_id, "decodeAddr": addr}
        srv.admissions = []
        job = await standin.submit(w_pre.worker_id, req)
        res = await asyncio.wait_for(job.result, 600)
        check(res.success, f"kvx {tag}: disaggregated run {res.error}")
        hand = standin.handoffs.get(req.id)
        check(hand is not None and hand["ok"] and hand["path"] == path,
              f"kvx {tag}: handoff {hand}")
        check(res.workerId == w_dec.worker_id, f"kvx {tag}: served by {res.workerId}")
        check(job.text == _final_text(res), f"kvx {tag}: the stream is not its final text")
        dis = results[req.id]
        check(dis.cached_tokens == hand["tokens"] > 0,
              f"kvx {tag}: decode admission cached {dis.cached_tokens}, imported "
              f"{hand['tokens']}")
        dis_logits = srv.admissions[-1][1]
        readings = {"export_gbps": exported.gbps(), "import_gbps": imported.gbps(),
                    "export_ms": exported.ms_each(), "import_ms": imported.ms_each()}
        a, b = _kvx_pages(pre, ids[:-1]), _kvx_pages(dec, ids[:-1])
        check(a["tokens"] == b["tokens"] and len(a["tokens"]) == hand["tokens"]
              and _np_equal(a["k"], b["k"]) and _np_equal(a["v"], b["v"]),
              f"kvx {tag}: imported pages differ from the exporter's")
        return {
            "path": path, "tokens_moved": hand["tokens"], "bytes": hand["bytes"],
            "transfer_s": hand["seconds"], "transfer_gbps": hand["bytes"] / hand["seconds"] / 1e9,
            **readings, "ttft_ms_unified": (uni.t_first - uni.t_submit) * 1e3,
            "ttft_ms_after_import": (job.t_first - standin.t_handoff[req.id]) * 1e3,
            "ttft_ms_disagg_end_to_end": (job.t_first - job.t_submit) * 1e3,
            "text_equal": job.text == uni.text, "texts": (uni.text, job.text),
            "eval_counts": [uni_res.response.eval_count, res.response.eval_count],
            "logits_rel_err": _rel_err(dis_logits, uni_logits),
            "migrated_bytes": int((res.usage or {}).get("migratedBytes") or 0),
        }
    finally:
        del os.environ["GRIDLLM_KVX_HTTP_BYTES"], os.environ["GRIDLLM_KVX_TIMEOUT_MS"]
        exported.restore()
        imported.restore()
        if http is not None:
            await http.cleanup()
        for w in (w_pre, w_dec):
            await w.stop(announce=False)
        await bus.disconnect()


def _np_equal(a, b) -> bool:
    import numpy as np

    return a.shape == b.shape and bool(np.array_equal(a, b))


async def _kvx_drain(victim_engine, peer_engine, prompt, tag) -> dict:
    """A job undisturbed on a unified worker, then the same job again,
    drained mid-decode: the worker suspends it, moves its pages to the peer
    (the one other worker on the bus) and hands it off; the stand-in resumes
    it there. Returns both streams and the readings."""
    import asyncio
    import os

    from gridllm_torch.bus import InMemoryBus
    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker.service import WorkerService

    bus = InMemoryBus()
    await bus.connect()
    standin = _KvxStandIn(bus)
    await standin.start()
    victim = WorkerService(bus, {WORKER_MODEL: victim_engine}, WorkerConfig(
        worker_id=f"kvx-{tag}-victim", heartbeat_interval_ms=1000), stream_flush_ms=20)
    peer = WorkerService(bus, {WORKER_MODEL: peer_engine}, WorkerConfig(
        worker_id=f"kvx-{tag}-peer", role="decode", heartbeat_interval_ms=1000),
        stream_flush_ms=20)
    os.environ["GRIDLLM_KVX_HTTP_BYTES"] = "0"
    os.environ["GRIDLLM_KVX_TIMEOUT_MS"] = "120000"
    try:
        for w in (victim, peer):
            await w.start()
        ref = await standin.submit(victim.worker_id, _worker_request(
            f"{tag}-ref", KVX_DRAIN_TOKENS, prompt))
        ref_res = await asyncio.wait_for(ref.result, 600)
        check(ref_res.success, f"kvx {tag}: undisturbed run {ref_res.error}")
        rid = f"{tag}-drain"
        job = await standin.submit(victim.worker_id, _worker_request(rid, KVX_DRAIN_TOKENS,
                                                                       prompt))
        await _wait(lambda: len(standin.snapshots.get(rid, {}).get("tokens", ()))
                    >= KVX_DRAIN_AFTER, f"{tag}: decode progress before the drain")
        report = await victim.drain(budget_ms=0)
        res = await asyncio.wait_for(job.result, 600)
    finally:
        del os.environ["GRIDLLM_KVX_HTTP_BYTES"], os.environ["GRIDLLM_KVX_TIMEOUT_MS"]
        for w in (victim, peer):
            await w.stop(announce=False)
        await bus.disconnect()
    msg = standin.drains.get(rid)
    check(report["suspended"] == 1 and msg is not None, f"kvx {tag}: drain {report} {msg}")
    check(res.success and res.workerId == peer.worker_id,
          f"kvx {tag}: drained job {res.error} on {res.workerId}")
    check(job.text == _final_text(res), f"kvx {tag}: the drained stream is not exactly once")
    check(peer.kvx.imported.get(rid, 0) > 0, f"kvx {tag}: the peer imported nothing")
    return {"text": job.text, "undisturbed_text": ref.text,
            "eval_counts": [ref_res.response.eval_count, res.response.eval_count],
            "snapshot_tokens": len((msg.get("snapshot") or {}).get("tokens", [])),
            "migrated": msg["migrated"], "bytes": msg["bytes"],
            "tokens_imported": peer.kvx.imported[rid]}


def _kvx_mixed_pools(torch, q8, fp, prompt) -> dict:
    """Engine to engine, no workers: an int8-pool engine's prefix exported
    (dequantized) into a bf16 engine, and the bf16 engine's copy exported
    back into the int8 engine (requantized per row): the bf16 pool holds the
    wire's bf16 pages bit for bit, the int8 pool the JAX package's
    requantization of them, and both serve the prompt warm."""
    import numpy as np

    from gridllm_torch.engine import GenerationRequest
    from gridllm_torch.ops.kvtier import quantize_rows_np
    from gridllm_torch.transfer.wire import Assembler, build_header

    def wire(src, tokens):
        out = _kvx_pages(src, tokens)
        h, p = build_header("mixed", WORKER_MODEL, out["tokens"], out["k"], out["v"],
                            dtype=out["dtype"], kv_layout=out["kvLayout"])
        asm = Assembler(dict(h))
        asm.feed_raw(p)
        return h, *asm.arrays()

    opts = {"temperature": 0.0, "num_predict": 16}
    first = q8.generate(GenerationRequest(id="q8", prompt=prompt, options=dict(opts)))
    ids = first.context[:first.prompt_eval_count]
    _kvx_evict(fp, ids)
    h, tokens, k, v = wire(q8, ids[:-1])
    check(fp.import_prefix_pages(tokens, k, v, h) == len(tokens), "kvx mixed: int8 → bf16")
    back = _kvx_pages(fp, ids[:-1])
    check(_np_equal(back["k"], k) and _np_equal(back["v"], v),
          "kvx mixed: the bf16 pool does not hold the int8 engine's dequantized pages")
    _kvx_evict(q8, ids)
    h2, tokens2, k2, v2 = wire(fp, ids[:-1])
    check(q8.import_prefix_pages(tokens2, k2, v2, h2) == len(tokens2), "kvx mixed: bf16 → int8")
    with q8._alloc_lock:
        pages, _ = q8.alloc.pin_prefix(ids)
        q8.alloc.unpin_pages(pages)
    idx = torch.tensor(pages, device="cuda")
    want_k, want_ks = quantize_rows_np(k2, "bfloat16")
    check(np.array_equal(q8.cache.k.data[:, idx].cpu().numpy(), want_k)
          and np.array_equal(q8.cache.k.scale[:, idx].cpu().numpy(), want_ks),
          "kvx mixed: the int8 pool does not hold the per-row requantization")
    warm = [e.generate(GenerationRequest(id=f"warm-{i}", prompt=prompt, options=dict(opts)))
            for i, e in enumerate((fp, q8))]
    for r in warm:
        check(r.cached_tokens == len(tokens) and r.done_reason in ("length", "stop"),
              f"kvx mixed: warm run cached {r.cached_tokens} ({r.done_reason})")
    return {"tokens_moved": len(tokens), "bytes_each_way": k.nbytes + v.nbytes,
            "int8_first_tokens": first.token_ids[:8],
            "bf16_warm_first_tokens": warm[0].token_ids[:8]}


def _kvx_tier_run(engine, prompts) -> dict:
    """Warm (cold, then a repeat from the device pool), two long prompts that
    evict it, the repeat again (restored from the host tier when there is
    one), then park the prompt's pages and repeat once more."""
    from gridllm_torch.engine import GenerationRequest

    opts = {"temperature": 0.0, "num_predict": 32}

    def one(rid, p, n=32):
        r = engine.generate(GenerationRequest(id=rid, prompt=p,
                                              options={**opts, "num_predict": n}))
        check(r.done_reason in ("length", "stop"), f"kvx tier: {rid} {r.error}")
        return r

    short, long1, long2 = prompts
    cold = one("cold", short)
    warm = one("warm", short)
    one("long1", long1, 4)
    one("long2", long2, 4)
    post = one("post", short)
    out = {"cold": cold, "warm": warm, "post": post}
    if engine.host_tier is not None:
        ps = engine.config.page_size
        free = engine.alloc.free_pages
        parked = engine.park_to_host(post.context[:post.prompt_eval_count - 1])
        check(parked > 0 and engine.alloc.free_pages == free + parked // ps,
              f"kvx tier: parked {parked} tokens, free pages {free} → "
              f"{engine.alloc.free_pages}")
        out["parked_tokens"] = parked
        out["resumed"] = one("resumed", short)
    return out


def _kvx_tier(torch, rng) -> dict:
    """The host tier on a pool of KVX_TIER_PAGES pages: bf16 llama3:8b with
    raw spills (spill and restore ms per page; the restored repeat equals
    the device-warm repeat; park frees its pages and the resume restores
    them), then the float32 cut with the tier on and off, whose greedy
    streams must be equal."""
    prompts = (_prompt(rng, 600), _prompt(rng, 1500), _prompt(rng, 1500))
    tier_kw = dict(num_pages=KVX_TIER_PAGES, kv_host_bytes=1 << 32, kv_spill_int8=False)
    engine = _kvx_engine(torch, **tier_kw)
    page_bytes = (engine.cache.k.nbytes + engine.cache.v.nbytes) // KVX_TIER_PAGES
    tier = engine.host_tier
    times: dict[str, list] = {"spill": [], "restore": []}

    def timed(kind, fn, count):
        # the wall of each call that spilled or restored a page (a spill of
        # a page the tier holds already returns at once), device synchronized
        def hook(*args):
            n, t0 = count(), time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            if count() > n:
                times[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return hook

    engine._spill_page_to_host = engine.alloc.spill_sink = timed(
        "spill", engine._spill_page_to_host, lambda: tier.spills)
    engine.alloc.restore_source = timed("restore", engine._restore_page_from_host,
                                        lambda: tier.restores)
    bf16 = _kvx_tier_run(engine, prompts)
    st = engine.host_tier.stats()
    del engine
    check(st["spills"] > 0 and st["restores"] > 0, f"kvx tier: {st}")
    check(bf16["post"].cached_tokens == bf16["warm"].cached_tokens > 0,
          f"kvx tier: restored {bf16['post'].cached_tokens} of {bf16['warm'].cached_tokens}")
    check(bf16["post"].token_ids == bf16["warm"].token_ids,
          "kvx tier: the restored repeat differs from the device-warm repeat")
    check(bf16["resumed"].token_ids == bf16["warm"].token_ids
          and bf16["resumed"].cached_tokens > 0, "kvx tier: the parked resume differs")
    f32 = {}
    for on in (True, False):
        engine = _kvx_engine(torch, model=_kvx_f32_model(), dtype="float32",
                             **(tier_kw if on else {"num_pages": KVX_TIER_PAGES}))
        f32[on] = _kvx_tier_run(engine, prompts)
        del engine
    check(f32[False]["post"].cached_tokens == 0 and f32[True]["post"].cached_tokens > 0,
          "kvx tier: the float32 runs did not evict, or the tier did not restore")
    check(all(r.token_ids == f32[False]["cold"].token_ids
              for run in f32.values() for k, r in run.items() if k != "parked_tokens"),
          "kvx tier: float32 greedy streams differ with the tier on and off")
    return {"page_bytes": page_bytes,
            "spill_ms_per_page": statistics.mean(times["spill"]),
            "spill_ms_per_page_median": statistics.median(times["spill"]),
            "restore_ms_per_page": statistics.mean(times["restore"]),
            "restore_ms_per_page_median": statistics.median(times["restore"]),
            "spills_timed": len(times["spill"]), "restores_timed": len(times["restore"]),
            "tier_stats": st,
            "restored_tokens": bf16["post"].cached_tokens,
            "parked_tokens": bf16["parked_tokens"],
            "f32_tier_on_off_equal": True}


def _kvx_f32_model() -> str:
    """llama3:8b at full width cut to KVX_F32_LAYERS layers, registered under
    its own name (two float32 engines and their pools fit on the card)."""
    import dataclasses

    from gridllm_torch.models.configs import REGISTRY, get_config, register

    name = f"{WORKER_MODEL}-f32-{KVX_F32_LAYERS}l"
    if name not in REGISTRY:
        register(dataclasses.replace(get_config(WORKER_MODEL), name=name,
                                     num_layers=KVX_F32_LAYERS))
    return name


def phase_kvx(torch) -> dict:
    """KV movement between two port WorkerServices on the port's
    InMemoryBus (the stand-in scheduler on the other side) and the host KV
    tier, llama3:8b with the engine's defaults:
    (a) disaggregated serving of a 1,500-byte prompt: a prefill-role worker
        prefills with export_only, exports and sends, once over bus chunks
        and once over HTTP to the decode worker's /kvx/ route (when aiohttp
        imports); the decode-role worker imports and streams. The imported
        pages equal the exporter's bit for bit; bf16 first-token logits are
        held to unified serving on the decode worker within
        SERVE_WARM_COLD_REL; in float32 (the cut) the stream equals it.
    (b) a graceful drain mid-decode moves the pages to the peer and the
        stream stays exactly once (bf16), byte-identical to the undisturbed
        run in float32;
    (c) an int8-pool engine's pages into a bf16 engine and back;
    (d) the host tier (_kvx_tier).
    The launch counters are 0 before (a) and read after (d); no plain
    version runs on the card."""
    import asyncio
    import importlib.util
    import random

    from gridllm_torch.ops import cuda_kernels as ck

    rng = random.Random(SEED + 13)
    prompt, drain_prompt = _prompt(rng, KVX_PROMPT_BYTES), _prompt(rng, 400)
    paths = ["bus"] + (["http"] if importlib.util.find_spec("aiohttp") else [])
    ck.reset_launch_counts()
    out: dict = {"phase": "kvx", "model": WORKER_MODEL, "card": card_line()}
    with _PlainWatch(torch) as plain:
        pre, dec = _kvx_engine(torch), _kvx_engine(torch)
        out["disagg_bf16"] = [asyncio.run(_kvx_disagg(torch, pre, dec, prompt, f"bf16-{p}", p))
                              for p in paths]
        for r in out["disagg_bf16"]:
            check(r["logits_rel_err"] <= SERVE_WARM_COLD_REL,
                  f"kvx: bf16 first-token logits after import depart {r['logits_rel_err']} "
                  f"> {SERVE_WARM_COLD_REL}")
            r["bf16_text_equal_unified"] = r.pop("text_equal")
            r.pop("texts")
        drained = asyncio.run(_kvx_drain(pre, dec, drain_prompt, "bf16"))
        # bf16, a reading: the resumed admission computes the rows after its
        # last moved page in a chunk (ROADMAP, "Not port faults")
        drained["equals_undisturbed"] = drained.pop("text") == drained.pop("undisturbed_text")
        out["drain_bf16"] = drained
        del pre
        q8 = _kvx_engine(torch, kv_int8=True)
        out["mixed_pools"] = _kvx_mixed_pools(torch, q8, dec, _prompt(rng, 900))
        del q8, dec
        f32 = [_kvx_engine(torch, model=_kvx_f32_model(), dtype="float32") for _ in range(2)]
        dis = asyncio.run(_kvx_disagg(torch, *f32, prompt, "f32-bus", "bus"))
        check(dis["text_equal"], f"kvx: float32 disaggregated stream differs: {dis['texts']}")
        dis.pop("texts")
        out["disagg_f32"] = dis
        drained = asyncio.run(_kvx_drain(*f32, drain_prompt, "f32"))
        check(drained.pop("text") == drained.pop("undisturbed_text")
              and len(set(drained["eval_counts"])) == 1,
              "kvx: the float32 drained stream differs from the undisturbed run")
        out["drain_f32"] = {**drained, "equals_undisturbed": True}
        del f32
        out["tier"] = _kvx_tier(torch, rng)
        launches = ck.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("ragged_attention", "paged_write_decode"):
        check(launches[name] > 0, f"kvx: {name} never launched: {launches}")
    check(not any(plain.counts.values()), f"kvx: a plain version ran on the card: {plain.counts}")
    out.update(launches=launches, plain_calls_on_card=plain.counts)
    return out


# ---------------------------------------------------------------------------
# gemma: gemma2 and head dim 256 in every attention kernel
# ---------------------------------------------------------------------------

# gemma2:9b attention widths (G = 2) and the engine's default pool geometry
GEMMA_H, GEMMA_KVH, GEMMA_D, GEMMA_MAXP = 16, 8, 256, 128
GEMMA_WINDOW, GEMMA_CAP = 4096, 50.0


def _gemma_kernel_cases(torch, inp: Inputs) -> tuple[list, dict]:
    """Every attention kernel and both KV writes at D = 256 (gemma2:9b's
    H = 16, KVH = 8, pages of 64, 128-entry tables) against its plain
    version: q scaled by LONG_Q_SCALE and each attention case held to the
    row-relative error at the kernel's tolerance (F32_TOL in float32), and
    to its launch counters (the kernel, and the route's leg, launched once
    per call). The cases: flash_prefill at T 1,024, 4,096 (seq_len 4,000)
    and a window of 4,096 with softcap 50 at T 8,192, float32 at T 1,000
    with a window; flash_prefill_streamed at T 16,384; ragged_attention's
    groups at Td 1 and 5 with and without the window, the chunk of 1,024
    after 1,024 and after 5,000 with the window, a mixed launch, the int8
    leg and the tree leg; paged_decode in both modes, prefix_chunk's three
    routes; both writes exact."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import (
        attention_prefill_blocked_ref,
        prefill_kernel,
        ragged_paged_attention_ref,
    )
    from gridllm_torch.ops.kernels import F32_TOL, by_name
    from gridllm_torch.ops.kvcache import write_decode, write_prefill
    from gridllm_torch.ops.spec import tree_topology

    h, kvh, d, maxp = GEMMA_H, GEMMA_KVH, GEMMA_D, GEMMA_MAXP
    bf16, f32 = torch.bfloat16, torch.float32
    win, cap = GEMMA_WINDOW, GEMMA_CAP
    cases, errs = [], {}

    def tol_of(kernel, dtype):
        return by_name(kernel).rtol if dtype == bf16 else F32_TOL

    def q4(*shape, dtype):
        return inp.randn(*shape, dtype=dtype) * LONG_Q_SCALE

    def held(kernel, name, dtype, got, want, counts0, expect, err_key=None):
        """Hold one call: row-relative error within the kernel's tolerance
        and each counter of `expect` ({counter: launches}) moved by exactly
        that many launches."""
        counts = ck.launch_counts()
        ran = {k: counts[k] - counts0[k] for k in expect}
        check(ran == expect, f"gemma {kernel} {name}: launches {ran}, expected {expect}")
        rel, err = _rel_err(got, want), _max_err(got, want)
        dname = str(dtype).split(".")[-1]
        tol = tol_of(kernel, dtype)
        cases.append({"kernel": kernel, "case": name, "dtype": dname, "D": d, "launches": ran,
                      "max_rel_err": rel, "max_abs_err": err, "bound": tol})
        check(rel <= tol, f"gemma {kernel} {dname} {name}: relative err {rel} > {tol}")
        if dtype == bf16:
            key = err_key or kernel
            errs[key] = max(errs.get(key, 0.0), err)

    # flash_prefill and flash_prefill_streamed (one kernel)
    prefill = [("t1024", bf16, 1024, [1024], 0, 0.0, "flash_prefill"),
               ("t4096_len4000", bf16, 4096, [4000], 0, 0.0, "flash_prefill"),
               ("t8192_window4096_softcap50", bf16, 8192, [8192], win, cap, "flash_prefill"),
               ("f32_t1000_window300_softcap50", f32, 1000, [1000], 300, cap, "flash_prefill"),
               ("t16384_len16000", bf16, 16384, [16000], 0, 0.0, "flash_prefill_streamed"),
               ("t16384_window4096_softcap50", bf16, 16384, [16384], win, cap,
                "flash_prefill_streamed")]
    for name, dtype, t, lens, window, softcap, kernel in prefill:
        check(prefill_kernel(t, d, torch.tensor([], dtype=dtype).element_size()) == kernel,
              f"gemma: prefill at T={t} does not route to {kernel}")
        q = q4(1, t, h, d, dtype=dtype)
        k, v = inp.randn(1, t, kvh, d, dtype=dtype), inp.randn(1, t, kvh, d, dtype=dtype)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        c0 = ck.launch_counts()
        got = getattr(ck, kernel)(q, k, v, sl, softcap=softcap, window=window)
        want = attention_prefill_blocked_ref(q, k, v, sl, logit_softcap=softcap, window=window)
        torch.cuda.synchronize()
        held(kernel, name, dtype, got[:, :lens[0]], want[:, :lens[0]], c0, {kernel: 1})
        del q, k, v, got, want
        torch.cuda.empty_cache()

    # paged attention on one pool layer of 8 x 128 pages, shuffled tables
    n_pages = S * maxp
    lengths = [0, 1, 63, 64, 1500, 4095, 5000, maxp * PS - 5]
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages, generator=inp.gen, device="cuda").to(torch.int32)
    table = perm.reshape(S, maxp).contiguous()
    topo = tree_topology(4, 2)
    depths, anc, bits = _tree_operands(topo)
    for dtype in (bf16, f32):
        dname = str(dtype).split(".")[-1]
        kp, vp = (inp.randn(1, n_pages, PS, kvh, d, dtype=dtype) for _ in range(2))
        quant = _quant_pools(torch, inp, 1, n_pages, d=d) if dtype == bf16 else quant
        pools = {"fp": (kp, vp, {}, kp, vp),
                 "int8": (quant[0].data, quant[1].data,
                          dict(k_scale=quant[0].scale, v_scale=quant[1].scale), *quant)}

        def group(td):
            return dict(q_group=q4(S, td, h, d, dtype=dtype), page_table=table,
                        group_lengths=glens, k_group=inp.randn(S, td, kvh, d, dtype=dtype),
                        v_group=inp.randn(S, td, kvh, d, dtype=dtype))

        def chunk(c, start, valid):
            return dict(q_chunk=q4(1, c, h, d, dtype=dtype), chunk_row=table[6],
                        chunk_start=start, chunk_total=start + valid,
                        k_chunk=inp.randn(c, kvh, d, dtype=dtype),
                        v_chunk=inp.randn(c, kvh, d, dtype=dtype))

        chunk_leg = "chunk" if dtype == bf16 else "chunk_cores"
        ragged = [("group_td1", group(1), 0, 0.0, None, ("group",)),
                  ("group_td5", group(5), 0, 0.0, None, ("group",)),
                  ("group_td1_window_softcap", group(1), win, cap, None, ("group",)),
                  ("group_td5_window_softcap", group(5), win, cap, None, ("group",)),
                  ("chunk_1024_after_1024", chunk(1024, 1024, 1024), 0, 0.0, 1024,
                   (chunk_leg,)),
                  ("chunk_1024_after_5000_window_softcap", chunk(1024, 5000, 1000), win, cap,
                   1000, (chunk_leg,)),
                  ("mixed_chunk_and_groups", {**chunk(1024, 1024, 1024), **group(1)}, win, cap,
                   1024, (chunk_leg, "group"))]
        tree_kw = dict(group(len(topo)), tree_pos=depths)
        for pool_name, (kd, vd, scales, kref, vref) in pools.items():
            runs = ragged + [("tree_k4_w2_window_softcap", tree_kw, win, cap, None,
                              ("group", "tree"))]
            for name, kw, window, softcap, valid, legs in runs:
                kw = dict(kw)
                tree = {}
                if "tree_pos" in kw:
                    kw.pop("tree_pos")
                    tree = dict(tree_pos=depths, tree_bits=bits)
                c0 = ck.launch_counts()
                oc, og = ck.ragged_attention(kd, vd, PS, layer=0, softcap=softcap,
                                             window=window, **scales, **tree, **kw)
                ref_tree = dict(tree_pos=depths, tree_mask=anc) if tree else {}
                wc, wg = ragged_paged_attention_ref(kref, vref, PS, layer=0,
                                                    logit_softcap=softcap, window=window,
                                                    **ref_tree, **kw)
                torch.cuda.synchronize()
                got = [] if oc is None else [oc[:, :valid].flatten(0, 1)]
                want = [] if wc is None else [wc[:, :valid].flatten(0, 1)]
                got += [] if og is None else [og.flatten(0, 1)]
                want += [] if wg is None else [wg.flatten(0, 1)]
                # a mixed step on the tensor-core route is two launches
                launches = 2 if (oc is not None and og is not None and dtype == bf16) else 1
                expect = {"ragged_attention": launches,
                          **{f"ragged_attention.{x}": 1 for x in legs},
                          "ragged_attention.int8": launches if scales else 0}
                key = ("ragged_attention.int8" if scales else
                       "ragged_attention.tree" if tree else
                       "ragged_attention.chunk" if oc is not None and og is None
                       else "ragged_attention")
                held("ragged_attention", f"{name}_{pool_name}", dtype, torch.cat(got),
                     torch.cat(want), c0, expect, err_key=key)
                del kw, oc, og, wc, wg, got, want
        # per-phase routes: paged_decode in both modes, prefix_chunk's
        # chunk (tensor cores in bf16, CUDA cores in float32) and slots
        nonempty = [i for i, ln in enumerate(lengths) if ln > 0]
        dec = dict(q=q4(S, h, d, dtype=dtype), k_pages=kp, v_pages=vp, page_table=table,
                   lengths=glens, page_size=PS, layer=0)
        cur = dict(k_cur=inp.randn(S, kvh, d, dtype=dtype), v_cur=inp.randn(S, kvh, d, dtype=dtype))
        ver = dict(q=q4(S, 5, h, d, dtype=dtype), k_pages=kp, v_pages=vp, page_table=table,
                   lengths=glens, page_size=PS, layer=0,
                   k_cur=inp.randn(S, 5, kvh, d, dtype=dtype),
                   v_cur=inp.randn(S, 5, kvh, d, dtype=dtype))
        bounds = torch.tensor([5000, 6000], dtype=torch.int32, device="cuda")
        pchunk = dict(q=q4(1, 1024, h, d, dtype=dtype), k_pages=kp, v_pages=vp,
                      table_row=table[6], start=bounds[0:1], total_len=bounds[1:2],
                      page_size=PS, layer=0)
        fresh = dict(k_cur=inp.randn(1024, kvh, d, dtype=dtype),
                     v_cur=inp.randn(1024, kvh, d, dtype=dtype))
        pchunk_leg = "prefix_chunk.chunk" if dtype == bf16 else "prefix_chunk.chunk_cores"
        per_phase = [("decode_merge_cur", "paged_decode", {**dec, **cur}, None, ()),
                     ("decode_in_pool", "paged_decode", dec, nonempty, ()),
                     ("verify_slots_t5", "prefix_chunk_slots", ver, None,
                      ("prefix_chunk.slots",)),
                     ("chunk_1024_after_5000", "prefix_chunk", {**pchunk, **fresh}, 1000,
                      (pchunk_leg,)),
                     ("chunk_1024_in_pool_after_5000", "prefix_chunk", pchunk, 1000,
                      (pchunk_leg,))]
        for name, wrapper, kw, rows, legs in per_phase:
            for window, softcap in ((0, 0.0), (win, cap)):
                c0 = ck.launch_counts()
                got = getattr(ck, wrapper)(**kw, softcap=softcap, window=window)
                want = _per_phase_plain(torch, wrapper, {**kw, "softcap": softcap,
                                                         "window": window})
                torch.cuda.synchronize()
                if wrapper == "paged_decode" and rows is not None:
                    got, want = got[rows], want[rows]
                elif wrapper == "prefix_chunk":
                    got, want = got[:, :rows], want[:, :rows]
                kernel = "prefix_chunk" if wrapper == "prefix_chunk_slots" else wrapper
                held(kernel, f"{name}_window{window}", dtype, got, want, c0,
                     {kernel: 1, **{leg: 1 for leg in legs}}, err_key=legs[0] if legs else None)
                del got, want
        del kp, vp, pools, dec, cur, ver, pchunk, fresh, ragged, tree_kw
        torch.cuda.empty_cache()
    del quant

    # both writes: a decode step's and a verify step's rows, and a chunk
    n_layers = 4
    for dtype in (bf16, f32):
        dname = str(dtype).split(".")[-1]
        kp = torch.zeros((n_layers, n_pages, PS, kvh, d), dtype=dtype, device="cuda")
        vp = torch.zeros_like(kp)
        for t in (1, 5):
            pos = (glens.clamp(max=maxp * PS - t)[:, None]
                   + torch.arange(t, device="cuda", dtype=torch.int32)).reshape(-1)
            active = torch.tensor([True] * (S - 1) + [False], device="cuda")
            kn = inp.randn(n_layers, S * t, kvh, d, dtype=dtype)
            vn = inp.randn(n_layers, S * t, kvh, d, dtype=dtype)
            c0 = ck.launch_counts()
            ck.paged_write_decode(kp, vp, kn, vn, table, pos, active, PS, rows_per_slot=t)
            want_k, want_v = write_decode(torch.zeros_like(kp), torch.zeros_like(vp), kn, vn,
                                          table.repeat_interleave(t, dim=0), pos,
                                          active.repeat_interleave(t), PS)
            torch.cuda.synchronize()
            exact = bool(torch.equal(kp, want_k) and torch.equal(vp, want_v))
            ran = ck.launch_counts()["paged_write_decode"] - c0["paged_write_decode"]
            cases.append({"kernel": "paged_write_decode", "case": f"rows_per_slot_{t}",
                          "dtype": dname, "D": d, "exact": exact, "launches": ran})
            check(exact and ran == 1, f"gemma paged_write_decode {dname} T={t}: exact {exact}, "
                                      f"{ran} launches")
            kp.zero_()
            vp.zero_()
            del kn, vn, want_k, want_v
        length, start = 1000, 1024
        kn = inp.randn(n_layers, 1024, kvh, d, dtype=dtype)
        vn = inp.randn(n_layers, 1024, kvh, d, dtype=dtype)
        c0 = ck.launch_counts()
        ck.paged_write_chunk(kp, vp, kn, vn, table[5], start, length, PS)
        want_k, want_v = write_prefill(torch.zeros_like(kp), torch.zeros_like(vp), kn, vn,
                                       table[5], start, length, PS)
        torch.cuda.synchronize()
        last = start + length - 1   # the kernel also writes the last page's padded tail
        kp[:, int(table[5][last // PS]), last % PS + 1:] = 0
        vp[:, int(table[5][last // PS]), last % PS + 1:] = 0
        exact = bool(torch.equal(kp, want_k) and torch.equal(vp, want_v))
        ran = ck.launch_counts()["paged_write_chunk"] - c0["paged_write_chunk"]
        cases.append({"kernel": "paged_write_chunk", "case": "1000_rows_after_1024",
                      "dtype": dname, "D": d, "exact": exact, "launches": ran})
        check(exact and ran == 1, f"gemma paged_write_chunk {dname}: exact {exact}, {ran} launches")
        if dtype == bf16:
            errs["paged_write_decode"] = errs["paged_write_chunk"] = 0.0
        del kp, vp, kn, vn, want_k, want_v
        torch.cuda.empty_cache()
    errs["prefix_chunk"] = max(errs["prefix_chunk.slots"], errs["prefix_chunk.chunk"])
    return cases, errs


def _gemma_timing(torch, inp: Inputs) -> dict:
    """Each kernel at D = 256 at the gemma2:9b serve path's shapes (bf16,
    CUDA events), with its plain version, one PyTorch call for the same
    function where there is one (SDPA, causal, GQA, for the prefill
    kernels; index_put_ for the writes) and the bound from this run's
    inputs: flash_prefill at T 4,096; flash_prefill_streamed at T 16,384;
    ragged_attention's decode group (8 slots at 1,024 cached) and its chunk
    kernel (1,024 after 1,024), on a bf16 pool and (the int8 leg) an int8
    pool, its tree leg (8 slots of the (4, 2) tree after 1,024);
    paged_decode at 8 x 1,024; prefix_chunk's chunk (1,024 after 1,024)
    and its verify over 8 slots x 5 after 1,024; both writes on a 42-layer
    pool. Keyed by the kernels line's names."""
    import torch.nn.functional as F

    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import (
        _prefix_chunk_ref,
        attention_prefill_blocked_ref,
        attention_prefill_ref,
        paged_attention_decode_ref,
        paged_attention_verify_ref,
        ragged_paged_attention_ref,
    )
    from gridllm_torch.ops.kvcache import write_decode, write_prefill
    from gridllm_torch.ops.spec import tree_topology

    h, kvh, d, maxp = GEMMA_H, GEMMA_KVH, GEMMA_D, GEMMA_MAXP
    bf16, res = torch.bfloat16, {}

    def prefill_row(t, plain, iters):
        q = inp.randn(1, t, h, d, dtype=bf16)
        k, v = inp.randn(1, t, kvh, d, dtype=bf16), inp.randn(1, t, kvh, d, dtype=bf16)
        sl = torch.tensor([t], dtype=torch.int32, device="cuda")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        b, op = bound_ms((2 * q.numel() + k.numel() + v.numel()) * 2, 4 * h * d * t * (t + 1) / 2)
        kernel = ck.flash_prefill if t <= 8192 else ck.flash_prefill_streamed
        row = {"shape": f"q[1,{t},{h},{d}] bf16",
               "ms": time_ms(torch, lambda: kernel(q, k, v, sl), iters=iters),
               "plain_ms": time_ms(torch, lambda: plain(q, k, v, sl), iters=1, warmup=1),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True), iters=iters),
               "bound_ms": b, "bound_by": op}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
        return row

    res["flash_prefill"] = prefill_row(4096, attention_prefill_ref, 20)
    res["flash_prefill_streamed"] = prefill_row(16384, attention_prefill_blocked_ref, 10)

    n_pages = S * maxp
    kp, vp = (inp.randn(1, n_pages, PS, kvh, d, dtype=bf16) for _ in range(2))
    quant = _quant_pools(torch, inp, 1, n_pages, d=d)
    perm = torch.randperm(n_pages, generator=inp.gen, device="cuda").to(torch.int32)
    table = perm.reshape(S, maxp).contiguous()
    lengths = [1024] * S
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def row_of(shape, fn, plain, nbytes, flops, library=None):
        b, op = bound_ms(nbytes, flops)
        return {"shape": shape, "ms": time_ms(torch, fn),
                "plain_ms": time_ms(torch, plain, iters=2, warmup=1),
                "library_ms": None if library is None else time_ms(torch, library),
                "bound_ms": b, "bound_by": op}

    def group(td):
        return dict(q_group=inp.randn(S, td, h, d, dtype=bf16), page_table=table,
                    group_lengths=glens, k_group=inp.randn(S, td, kvh, d, dtype=bf16),
                    v_group=inp.randn(S, td, kvh, d, dtype=bf16))

    gkw = group(1)
    nb, fl = _group_work(lengths, 1, h, kvh, d, [1])
    res["ragged_attention"] = row_of(
        f"decode group S={S} Td=1 context=1024 D={d} bf16",
        lambda: ck.ragged_attention(kp, vp, PS, layer=0, **gkw),
        lambda: ragged_paged_attention_ref(kp, vp, PS, layer=0, **gkw), nb, fl)
    scales = dict(k_scale=quant[0].scale, v_scale=quant[1].scale)
    nb8 = nb - sum(lengths) * kvh * d * 2 * 2 + sum(lengths) * (kvh * d + 4) * 2
    res["ragged_attention.int8"] = row_of(
        f"decode group S={S} Td=1 context=1024 D={d} int8 pool, bf16 compute",
        lambda: ck.ragged_attention(quant[0].data, quant[1].data, PS, layer=0, **scales, **gkw),
        lambda: ragged_paged_attention_ref(*quant, PS, layer=0, **gkw), nb8, fl)
    topo = tree_topology(4, 2)
    depths, anc, bits = _tree_operands(topo)
    n = len(topo)
    tkw = group(n)
    visible = [int(r.sum()) for r in anc]
    nb, fl = _group_work(lengths, n, h, kvh, d, visible)
    res["ragged_attention.tree"] = row_of(
        f"tree verify S={S} N={n} context=1024 D={d} bf16",
        lambda: ck.ragged_attention(kp, vp, PS, layer=0, tree_pos=depths, tree_bits=bits,
                                    **tkw),
        lambda: ragged_paged_attention_ref(kp, vp, PS, layer=0, tree_pos=depths, tree_mask=anc,
                                           **tkw), nb, fl)
    c, start = 1024, 1024
    ckw = dict(q_chunk=inp.randn(1, c, h, d, dtype=bf16), chunk_row=table[0], chunk_start=start,
               chunk_total=start + c, k_chunk=inp.randn(c, kvh, d, dtype=bf16),
               v_chunk=inp.randn(c, kvh, d, dtype=bf16))
    nb = (2 * c * h * d + (start + c) * kvh * d * 2) * 2
    fl = 4 * h * d * c * (start + (c + 1) / 2)
    res["ragged_attention.chunk"] = row_of(
        f"chunk region C={c} after {start} cached tokens D={d} bf16",
        lambda: ck.ragged_attention(kp, vp, PS, layer=0, **ckw),
        lambda: ragged_paged_attention_ref(kp, vp, PS, layer=0, **ckw), nb, fl)
    res["ragged_attention.chunk"]["int8_pool_ms"] = time_ms(
        torch, lambda: ck.ragged_attention(quant[0].data, quant[1].data, PS, layer=0, **scales,
                                           **ckw))
    # per-phase routes
    q1, kc1, vc1 = gkw["q_group"][:, 0], gkw["k_group"][:, 0], gkw["v_group"][:, 0]
    nb, fl = _group_work(lengths, 1, h, kvh, d, [1])
    res["paged_decode"] = row_of(
        f"S={S} context=1024 D={d} bf16",
        lambda: ck.paged_decode(q1, kp, vp, table, glens, PS, kc1, vc1, layer=0),
        lambda: paged_attention_decode_ref(q1, kp[0], vp[0], table, glens, PS, k_cur=kc1,
                                           v_cur=vc1), nb, fl)
    vkw = group(5)
    nb, fl = _group_work(lengths, 5, h, kvh, d, list(range(1, 6)))
    res["prefix_chunk.slots"] = row_of(
        f"verify S={S} T=5 context=1024 D={d} bf16",
        lambda: ck.prefix_chunk_slots(vkw["q_group"], kp, vp, table, glens, PS,
                                      vkw["k_group"], vkw["v_group"], layer=0),
        lambda: paged_attention_verify_ref(vkw["q_group"], kp[0], vp[0], table, glens, PS,
                                           vkw["k_group"], vkw["v_group"]), nb, fl)
    bounds = torch.tensor([start, start + c], dtype=torch.int32, device="cuda")
    nb = (2 * c * h * d + (start + c) * kvh * d * 2) * 2
    fl = 4 * h * d * c * (start + (c + 1) / 2)
    res["prefix_chunk.chunk"] = row_of(
        f"chunk C={c} after {start} cached tokens D={d} bf16",
        lambda: ck.prefix_chunk(ckw["q_chunk"], kp, vp, table[0], bounds[0:1], bounds[1:2], PS,
                                ckw["k_chunk"], ckw["v_chunk"], layer=0),
        lambda: _prefix_chunk_ref(ckw["q_chunk"], kp[0], vp[0], table[0], start, start + c, PS,
                                  k_cur=ckw["k_chunk"], v_cur=ckw["v_chunk"]), nb, fl)
    res["prefix_chunk"] = dict(res["prefix_chunk.chunk"])
    del kp, vp, quant, gkw, tkw, vkw, ckw
    torch.cuda.empty_cache()

    # the writes on a 42-layer pool (gemma2:9b's layers), 8 decode rows and a
    # 1,024-row chunk
    n_layers = 42
    kp = torch.zeros((n_layers, n_pages, PS, kvh, d), dtype=bf16, device="cuda")
    vp = torch.zeros_like(kp)
    row_bytes = kvh * d * 2
    positions = torch.tensor([1024 + 7 * s for s in range(S)], dtype=torch.int32, device="cuda")
    active = torch.ones(S, dtype=torch.bool, device="cuda")
    kn, vn = (inp.randn(n_layers, S, kvh, d, dtype=bf16) for _ in range(2))
    pidx = table[torch.arange(S, device="cuda"), (positions // PS).long()].long()
    off = (positions % PS).long()

    def lib_decode():
        kp[:, pidx, off] = kn
        vp[:, pidx, off] = vn

    res["paged_write_decode"] = row_of(
        f"pool[{n_layers},{n_pages},{PS},{kvh},{d}] S={S} bf16",
        lambda: ck.paged_write_decode(kp, vp, kn, vn, table, positions, active, PS),
        lambda: write_decode(kp, vp, kn, vn, table, positions, active, PS),
        2 * 2 * n_layers * S * row_bytes, 0, library=lib_decode)
    t = 1024
    kn, vn = (inp.randn(n_layers, t, kvh, d, dtype=bf16) for _ in range(2))
    cpos = torch.arange(t, device="cuda")
    cpage, coff = table[0][(cpos // PS).long()].long(), (cpos % PS).long()

    def lib_chunk():
        kp[:, cpage, coff] = kn
        vp[:, cpage, coff] = vn

    res["paged_write_chunk"] = row_of(
        f"chunk[{n_layers},{t},{kvh},{d}] start=0 bf16",
        lambda: ck.paged_write_chunk(kp, vp, kn, vn, table[0], 0, t, PS),
        lambda: write_prefill(kp, vp, kn, vn, table[0], 0, t, PS),
        2 * 2 * n_layers * t * row_bytes, 0, library=lib_chunk)
    del kp, vp, kn, vn
    torch.cuda.empty_cache()
    return res


GEMMA_MODEL = "gemma2:9b"
GEMMA_CUT_LAYERS = 2
GEMMA_CUT_PROMPT = 5000    # past layer 0's window of 4096: its keys drop
GEMMA_LONG_BYTES = 6000    # the serve's long prompt: six chunks of 1024 across the window


def _cut(base: str, layers: int) -> str:
    """Model `base` at full width cut to `layers` layers, registered under
    its own name."""
    import dataclasses

    from gridllm_torch.models.configs import REGISTRY, get_config, register

    name = f"{base}-{layers}l"
    if name not in REGISTRY:
        register(dataclasses.replace(get_config(base), name=name, num_layers=layers))
    return name


def _gemma_model(torch) -> dict:
    """gemma2:9b cut to 2 layers, full width, float32, against its
    cache-free forward (whose attention is the blocked plain version), in
    both attention modes, on a 5,000-token prompt (layer 0's window of
    4,096 drops keys): ragged (the prompt prefilled whole in the 8,192
    bucket, 8 decode steps, a verify step of K+1 = 5) and per-phase (the
    prompt admitted in five prefill_chunk calls of 1,024, 4 decode steps, a
    verify step). Only the last rows' logits are made: [5016, 256000]
    float32 would be 5.1 GB."""
    from unittest import mock

    from gridllm_torch.models import llama
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.models.gemma import Gemma2
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_blocked_ref
    from gridllm_torch.ops.kernels import F32_TOL
    from gridllm_torch.ops.kvcache import PagedKVCache, rollback_to_length

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    cfg = get_config(_cut(GEMMA_MODEL, GEMMA_CUT_LAYERS))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 14)
    model = Gemma2(cfg, dtype=torch.float32, device="cuda").init_params(gen)
    # random norm weights: the (1 + w) norms with w = 0 would hide a norm
    # that ignores its weight
    for name in model.NORMS:
        model.layers[name].normal_(0.0, 0.3, generator=gen)
    model.final_norm.data.normal_(0.0, 0.3, generator=gen)
    n, extra, k1, bucket = GEMMA_CUT_PROMPT, 16, 5, 8192
    toks = torch.randint(0, cfg.vocab_size, (n + extra,), generator=gen, device="cuda",
                         dtype=torch.int32)
    rows = extra + 1                                   # positions n - 1 .. n + extra - 1
    unembed = model._unembed
    with mock.patch.object(llama, "attention_prefill", attention_prefill_blocked_ref), \
            mock.patch.object(model, "_unembed", lambda x: unembed(x[:, -rows:])):
        want = model(toks[None])[0]                    # [rows, V]
    check(model._window(0) == 4096 and model._window(1) == 0 and n > 4096,
          "gemma model: layer 0 does not slide past its window")
    maxp = bucket // PS
    cache = PagedKVCache.create(cfg.num_layers, 2 * maxp, PS, cfg.num_kv_heads, cfg.head_dim_, 2,
                                maxp, dtype=torch.float32, device="cuda")
    table = torch.arange(2 * maxp, device="cuda", dtype=torch.int32).reshape(2, maxp)
    errs = {"ragged": [], "per_phase": []}

    def err(mode, got, pos):
        errs[mode].append(float((got - want[pos - (n - 1)]).abs().max()))

    def decode_verify(mode, slot, steps):
        active = torch.zeros(2, dtype=torch.bool, device="cuda")
        active[slot] = True
        cur = torch.zeros(2, dtype=torch.int32, device="cuda")
        for _ in range(steps):
            pos = int(cache.lengths[slot])
            cur[slot] = toks[pos]
            logits, _ = mdl.decode_step(cur, cache, active)
            err(mode, logits[slot], pos)
        base = int(cache.lengths[slot])
        cand = torch.zeros((2, k1), dtype=torch.int32, device="cuda")
        cand[slot] = toks[base:base + k1]
        logits, _ = mdl.verify_step(cand, cache, active)
        for j in range(k1):
            err(mode, logits[slot, j], base + j)
        rollback_to_length(cache, cache.lengths + k1 * active.to(torch.int32))

    counts = {}
    mdl = model
    ck.reset_launch_counts()
    padded = torch.cat([toks[:n], torch.zeros(bucket - n, dtype=torch.int32, device="cuda")])
    logits, _ = mdl.prefill(padded, n, cache, 0, table[0])
    err("ragged", logits, n - 1)
    decode_verify("ragged", 0, 8)
    counts["ragged"] = ck.launch_counts()
    mdl = Gemma2(cfg, dtype=torch.float32, device="cuda", ragged_attention=False)
    mdl.load_state_dict(model.state_dict())
    del model
    ck.reset_launch_counts()
    for start in range(0, n, 1024):
        length = min(1024, n - start)
        chunk = torch.zeros(1024, dtype=torch.int32, device="cuda")
        chunk[:length] = toks[start:start + length]
        logits, _ = mdl.prefill_chunk(chunk, start, length, cache, 1, table[1])
    err("per_phase", logits, n - 1)
    decode_verify("per_phase", 1, 4)
    counts["per_phase"] = ck.launch_counts()
    torch.cuda.synchronize()
    layers = cfg.num_layers
    check(counts["ragged"]["flash_prefill_streamed"] == layers
          and counts["ragged"]["ragged_attention"] == 9 * layers
          and counts["ragged"]["paged_decode"] + counts["ragged"]["prefix_chunk"] == 0,
          f"gemma model: ragged launches {counts['ragged']}")
    check(counts["per_phase"]["prefix_chunk.chunk_cores"] == 5 * layers
          and counts["per_phase"]["paged_decode"] == 4 * layers
          and counts["per_phase"]["prefix_chunk.slots"] == layers
          and counts["per_phase"]["ragged_attention"] == 0,
          f"gemma model: per-phase launches {counts['per_phase']}")
    worst = {mode: max(e) for mode, e in errs.items()}
    check(max(worst.values()) <= F32_TOL, f"gemma model: paged path differs from forward by "
                                          f"{worst}")
    del mdl, cache, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": f"{GEMMA_MODEL}, {layers} layers, float32, random norms",
            "prompt": n, "window_layer0": 4096,
            "logit_rows_compared": {m: len(e) for m, e in errs.items()},
            "max_abs_err": worst, "bound": F32_TOL,
            "launches": {m: {k: v for k, v in c.items() if v} for m, c in counts.items()}}


def _gemma_serve(torch) -> dict:
    """gemma2:9b bf16 at full width with the engine's defaults (speculation
    and ragged attention on, pages of 64, 1,024 pages, random weights from
    seed 0): the serve phase's eight concurrent requests plus a
    6,000-byte prompt admitted in chunks of 1,024 across the window, then
    its warm repeat from the prefix cache. Launch counters from 0 over the
    run, held to the ragged path's kernels (_PATHS["spec_ragged"]); every
    ragged launch at D = 256. Then the same model with the per-phase
    kernels (ragged attention off, spec on): the long prompt beside a short
    one and the short one's warm repeat, held to _PATHS["spec_per_phase"]."""
    import random

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.ops import cuda_kernels as ck

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = Served(torch, InferenceEngine(EngineConfig(model=GEMMA_MODEL), device="cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    engine = srv.engine
    cfg = engine.cfg
    check(type(engine.model).__name__ == "Gemma2" and cfg.head_dim_ == GEMMA_D,
          "gemma serve: the engine did not build Gemma2")
    vocab, slots, k1 = srv.vocab, engine.config.max_slots, engine.config.spec_k + 1
    weights_gb = sum(p.numel() * p.element_size() for p in engine.model.parameters()) / 1e9
    pool_gb = (engine.cache.k.numel() * engine.cache.k.element_size()) * 2 / 1e9
    dims = []
    ragged = ck.ragged_attention

    def watched(*args, **kwargs):   # the head dim of every ragged launch
        dims.append(int((args[0] if args else kwargs["k_pages"]).shape[-1]))
        return ragged(*args, **kwargs)

    ck.ragged_attention = watched
    try:
        engine.start()
        _, _, _, batch_a = _serve_prompts()
        long_prompt = _prompt(random.Random(SEED + 14), GEMMA_LONG_BYTES)
        ck.reset_launch_counts()
        chunks0 = srv.calls.get("mixed_step", 0) + srv.calls.get("prefill_chunk", 0)
        res, wall = srv.run(batch_a + [(long_prompt, 48)])
        long_res = res[-1]
        check(long_res.prompt_eval_count > GEMMA_WINDOW + 1024,
              f"gemma serve: the long prompt has {long_res.prompt_eval_count} tokens")
        (warm,), wall_warm = srv.run([(long_prompt, 48)])
        check(warm.cached_tokens > GEMMA_WINDOW,
              f"gemma serve: the warm repeat hit {warm.cached_tokens} cached tokens")
        summary = srv.summary(res, wall, {(vocab,), (slots, vocab), (slots, k1, vocab)})
        launches = _path_launches(ck, "spec_ragged", srv)
    finally:
        ck.ragged_attention = ragged
    check(set(dims) == {GEMMA_D}, f"gemma serve: ragged launches at head dims {set(dims)}")
    steps = engine.spec_stats["steps"]
    matching = 0
    for a, b in zip(long_res.token_ids, warm.token_ids):
        if a != b:
            break
        matching += 1
    out = {
        "model": GEMMA_MODEL, "dtype": "bfloat16", "load_s": load_s,
        "weights_gb": weights_gb, "kv_pool_gb": pool_gb,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "long_prompt_tokens": long_res.prompt_eval_count,
        "long_ttft_ms": long_res.prompt_eval_duration_ns / 1e6,
        "chunk_and_mixed_steps": srv.calls.get("mixed_step", 0) + srv.calls.get(
            "prefill_chunk", 0) - chunks0,
        "warm_cached_tokens": warm.cached_tokens,
        "warm_ttft_ms": warm.prompt_eval_duration_ns / 1e6, "warm_wall_s": wall_warm,
        "warm_tokens_matching_cold": f"{matching}/{len(warm.token_ids)}",
        "verify_steps": steps, "launches": launches, **summary,
    }
    _free(torch, srv)

    srv = Served(torch, InferenceEngine(EngineConfig(model=GEMMA_MODEL, ragged_attention=False),
                                        device="cuda"))
    srv.engine.start()
    short = _prompt(random.Random(SEED + 15), 200)
    ck.reset_launch_counts()
    res, wall = srv.run([(long_prompt, 32), (short, 32)])
    (repeat,), _ = srv.run([(short, 32)])
    check(repeat.cached_tokens > 0, "gemma serve per-phase: the repeat missed the prefix cache")
    out["per_phase"] = {**srv.summary(res, wall, {(vocab,), (slots, k1, vocab)}),
                        "long_ttft_ms": res[0].prompt_eval_duration_ns / 1e6,
                        "repeat_cached_tokens": repeat.cached_tokens,
                        "launches": _path_launches(ck, "spec_per_phase", srv)}
    _free(torch, srv)
    return out


def _gemma_spec(torch) -> dict:
    """The 2-layer float32 gemma2:9b cut behind the engine: a repetitive
    prompt longer than the window gives the same greedy stream with
    speculative decoding on and off, with ragged attention on and off."""
    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine

    name = _cut(GEMMA_MODEL, GEMMA_CUT_LAYERS)
    prompt = "the cat sat on the mat and the dog sat on the log. " * 90   # 4,591 bytes
    opts = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 64}
    runs, streams = {}, {}
    for ragged in (True, False):
        for spec in (True, False):
            gc.collect()
            torch.cuda.empty_cache()
            engine = InferenceEngine(EngineConfig(model=name, dtype="float32", spec_decode=spec,
                                                  ragged_attention=ragged), device="cuda")
            res = engine.generate(GenerationRequest(id="gemma-spec", prompt=prompt,
                                                    options=dict(opts)))
            check(res.done_reason in ("length", "stop") and res.token_ids,
                  f"gemma spec: finished {res.done_reason!r} ({res.error})")
            key = f"spec_{'on' if spec else 'off'}_ragged_{'on' if ragged else 'off'}"
            streams[key] = res.token_ids
            runs[key] = {"prompt_tokens": res.prompt_eval_count, "proposed": res.spec_proposed,
                         "accepted": res.spec_accepted,
                         "verify_steps": engine.spec_stats["steps"]}
            del engine
    gc.collect()
    torch.cuda.empty_cache()
    ref = streams["spec_off_ragged_on"]
    same = {key: toks == ref for key, toks in streams.items()}
    check(all(same.values()), f"gemma spec: greedy streams differ: {same}")
    check(runs["spec_on_ragged_on"]["prompt_tokens"] > GEMMA_WINDOW,
          "gemma spec: the prompt does not pass the window")
    return {"model": name, "dtype": "float32", "tokens": len(ref), "streams_identical": True,
            "runs": runs}


def phase_gemma(torch) -> dict:
    """gemma2 and head dim 256 (see the module docstring): every kernel at
    D = 256 against its plain version and timed, the 2-layer float32 cut in
    both attention modes, gemma2:9b bf16 served with the engine's
    defaults, and float32 spec parity on the cut."""
    inp = Inputs(torch, SEED + 14)
    t0 = time.perf_counter()
    cases, errs = _gemma_kernel_cases(torch, inp)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gemma_kernel_cases.json").write_text(json.dumps(cases, indent=1))
    seconds = {"kernel_cases": time.perf_counter() - t0}
    parts = {}
    for part, fn in (("timing", lambda: _gemma_timing(torch, inp)),
                     ("model", lambda: _gemma_model(torch)),
                     ("serve", lambda: _gemma_serve(torch)),
                     ("spec", lambda: _gemma_spec(torch))):
        t0 = time.perf_counter()
        parts[part] = fn()
        seconds[part] = time.perf_counter() - t0
    return {"phase": "gemma", "card": card_line(), "cases": len(cases),
            "max_rel_err": max(c.get("max_rel_err", 0.0) for c in cases),
            "max_abs_err_bf16": errs, **parts, "part_seconds": seconds,
            "launches": parts["serve"]["launches"]}


# ---------------------------------------------------------------------------
# int8 weights: llama3:70b on one card (phase_quant)
# ---------------------------------------------------------------------------

QUANT_MODEL = "llama3:70b"
QUANT_RESERVE = 4 << 30     # device bytes left beside the weights and the pool
QUANT_MIN_PAGES = 128       # 8,192 tokens: the run's nine requests need ~6,100
QUANT_LONG_BYTES = 2000     # the ninth prompt: two chunks of 1,024
QUANT_REL_BOUND = 0.15      # int8 against float logits (the JAX test's bound)


def _quant_bits(torch) -> dict:
    """One llama3:70b layer slice (w_gate's [8192, 28672]) quantized on the
    card bit-equal to the CPU: quantize_array on the card, the blocked
    quantize_into the loader and init use, and the CPU's quantize_array of
    the same bf16 values give the same int8 values and scale bits."""
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.ops.quant import QuantizedTensor, quantize_array, quantize_into

    cfg = get_config(QUANT_MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    e, f = cfg.hidden_size, cfg.intermediate_size
    w = (torch.randn((e, f), generator=gen, device="cuda") * e ** -0.5).to(torch.bfloat16)
    w[:, 0] = 0                                       # a zero channel: its floor
    card = quantize_array(w)
    blocked = QuantizedTensor(torch.empty_like(card.q), torch.empty_like(card.scale))
    quantize_into(blocked, w)
    cpu = quantize_array(w.cpu())
    same = {
        "q": bool(torch.equal(card.q.cpu(), cpu.q)),
        "scale_bits": bool(torch.equal(card.scale.cpu().view(torch.int32),
                                       cpu.scale.view(torch.int32))),
        "blocked_q": bool(torch.equal(blocked.q, card.q)),
        "blocked_scale_bits": bool(torch.equal(blocked.scale.view(torch.int32),
                                               card.scale.view(torch.int32))),
    }
    check(all(same.values()), f"quant: the card's quantization differs from the CPU's: {same}")
    return {"slice": [e, f], "bit_equal": same,
            "scale_floor_channel": float(card.scale[0])}


def _quant_timing(torch, inp: Inputs) -> dict:
    """qdot at a decode shape (8 rows x 8,192 -> 28,672, llama3:70b's
    w_gate) against the bf16 torch.matmul on the same shape; the bounds of
    both, and of the plain qdot's traffic (int8 read, bf16 copy written
    and read)."""
    from gridllm_torch.ops.quant import qdot, quantize_array

    rows, e, f = 8, 8192, 28672
    x = inp.randn(rows, e, dtype=torch.bfloat16)
    w = (inp.randn(e, f, dtype=torch.float32) * e ** -0.5).to(torch.bfloat16)
    qw = quantize_array(w)
    out_bytes, x_bytes = rows * f * 2, rows * e * 2
    flops = 2 * rows * e * f
    res = {"shape": [rows, e, f],
           "qdot_ms": time_ms(torch, lambda: qdot(x, qw)),
           "qdot_device_ms": device_ms(torch, lambda: qdot(x, qw)),
           "bf16_matmul_ms": time_ms(torch, lambda: x @ w),
           "bf16_matmul_device_ms": device_ms(torch, lambda: x @ w)}
    err = float((qdot(x, qw).float() - (x @ qw.dequantize(torch.bfloat16)).float()).abs().max())
    check(err <= 3e-2 * float((x @ w).float().abs().max()),
          f"quant: qdot differs from the dequantized product by {err}")
    res["int8_read_bound_ms"], _ = bound_ms(e * f + f * 4 + x_bytes + out_bytes, flops)
    res["plain_traffic_bound_ms"], _ = bound_ms(e * f * (1 + 2 + 2) + f * 4 + x_bytes
                                                + out_bytes, flops)
    res["bf16_bound_ms"], res["bound_by"] = bound_ms(e * f * 2 + x_bytes + out_bytes, flops)
    return res


def _paged_vs_forward(torch, model, seed: int) -> dict:
    """The ragged paged path of a float32 model against its cache-free
    forward: slot 0 prefills 192 tokens in the 256 bucket and decodes 32,
    slot 1 admits the sequence in two 64-token mixed steps beside slot 0's
    decode rows, then two verify steps of K+1 = 5 for both. Max abs logit
    error by entry point."""
    from gridllm_torch.ops.kvcache import PagedKVCache, rollback_to_length

    cfg = model.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n, k1 = 320, 5
    toks = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    want = model(toks[None])[0]
    cache = PagedKVCache.create(cfg.num_layers, 32, PS, cfg.num_kv_heads, cfg.head_dim_, 4, 8,
                                dtype=torch.float32, device="cuda")
    rows = torch.arange(32, device="cuda", dtype=torch.int32).reshape(4, 8)
    errs: dict[str, float] = {}
    cur = torch.zeros(4, dtype=torch.int32, device="cuda")

    def err(kind, got, pos):
        errs[kind] = max(errs.get(kind, 0.0), float((got - want[pos]).abs().max()))

    logits, _ = model.prefill(torch.cat([toks[:192], toks[:64] * 0]), 192, cache, 0, rows[0])
    err("prefill", logits, 191)
    active = torch.tensor([True, False, False, False], device="cuda")
    for pos in range(192, 224):
        cur[0] = toks[pos]
        logits, _ = model.decode_step(cur, cache, active)
        err("decode", logits[0], pos)
    for start, pos in ((0, 224), (64, 225)):
        cur[0] = toks[pos]
        chunk_logits, dec_logits, _ = model.mixed_step(
            toks[start:start + 64], start, 64, 1, rows[1], cur, cache, active)
        err("mixed_chunk", chunk_logits, start + 63)
        err("mixed_decode", dec_logits[0], pos)
    active = torch.tensor([True, True, False, False], device="cuda")
    for _ in range(2):
        lens = cache.lengths.tolist()
        cand = torch.zeros((4, k1), dtype=torch.int32, device="cuda")
        for s in (0, 1):
            cand[s] = toks[lens[s]:lens[s] + k1]
        logits, _ = model.verify_step(cand, cache, active)
        for s in (0, 1):
            for j in range(k1):
                err("verify", logits[s, j], lens[s] + j)
        rollback_to_length(cache, cache.lengths + k1 * active.to(torch.int32))
    torch.cuda.synchronize()
    return errs


def _quant_model(torch) -> dict:
    """llama3:70b cut to 2 layers at full width in float32 with int8
    weights: the paged path against its own cache-free forward to F32_TOL,
    and its logits against the unquantized model's (the same generator:
    the int8 model's weights are the float model's int8 pairs) within
    QUANT_REL_BOUND of their largest."""
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.models.llama import Llama
    from gridllm_torch.ops.kernels import F32_TOL

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(_cut(QUANT_MODEL, 2))
    models = {}
    for quantize in ("int8", None):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 15)
        models[quantize] = Llama(cfg, dtype=torch.float32, device="cuda",
                                 quantize=quantize).init_params(gen)
    check(models["int8"].layers["w_down"].dtype == torch.int8, "quant model: not int8")
    errs = _paged_vs_forward(torch, models["int8"], SEED + 16)
    check(max(errs.values()) <= F32_TOL, f"quant model: paged path differs from forward "
                                          f"by {errs}")
    toks = torch.randint(0, cfg.vocab_size, (1, 256), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(SEED + 17))
    q_logits, f_logits = models["int8"](toks), models[None](toks)
    rel = float((q_logits - f_logits).abs().max() / f_logits.abs().max())
    check(0 < rel < QUANT_REL_BOUND, f"quant model: int8 logits {rel} from the float ones")
    del models, q_logits, f_logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": f"{QUANT_MODEL}, 2 layers, float32, int8 weights",
            "max_abs_err": errs, "bound": F32_TOL, "int8_vs_float_rel": rel,
            "rel_bound": QUANT_REL_BOUND}


def _meta_nbytes(torch, name: str, quantize) -> int:
    """A model's parameter bytes from its shapes (meta tensors)."""
    from gridllm_torch.engine.loader import model_class
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.ops.quant import params_nbytes

    cfg = get_config(name)
    return params_nbytes(model_class(cfg)(cfg, dtype=torch.bfloat16, device="meta",
                                          quantize=quantize).params_tree())


def _quant_serve(torch) -> dict:
    """llama3:70b with quantize="int8", all 80 layers at full width, bf16
    activations, random weights from seed 0, the engine's defaults
    (speculation, ragged attention and the prefix cache on), the pool
    sized to the device memory the weights leave (QUANT_RESERVE kept for
    the activations): the serve phase's eight requests plus a 2,000-byte
    prompt in chunks of 1,024. Launch counters from 0 over the run, held to
    the ragged path's kernels."""
    import random

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.quant import params_nbytes
    from gridllm_torch.tools import profile_step

    cfg = get_config(QUANT_MODEL)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    predicted = _meta_nbytes(torch, QUANT_MODEL, "int8")
    page_bytes = 2 * cfg.num_layers * PS * cfg.num_kv_heads * cfg.head_dim_ * 2
    pages = int((free - predicted - QUANT_RESERVE) // page_bytes)
    check(pages >= QUANT_MIN_PAGES, f"quant serve: room for {pages} pages only "
                                    f"({free / 2**30:.2f} GiB free)")
    t0 = time.perf_counter()
    srv = Served(torch, InferenceEngine(EngineConfig(model=QUANT_MODEL, quantize="int8",
                                                     num_pages=pages), device="cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    engine = srv.engine
    weights = params_nbytes(engine.model.params_tree())
    check(weights == predicted, f"quant serve: {weights} weight bytes, {predicted} predicted")
    check(all(engine.model.layers[k].dtype == torch.int8 for k in ("wq", "w_down"))
          and engine.model.lm_head.dtype == torch.int8, "quant serve: weights not int8")
    vocab, slots, k1 = srv.vocab, engine.config.max_slots, engine.config.spec_k + 1
    engine.start()
    _, _, _, batch_a = _serve_prompts()
    long_prompt = _prompt(random.Random(SEED + 15), QUANT_LONG_BYTES)
    ck.reset_launch_counts()
    res, wall = srv.run(batch_a + [(long_prompt, 32)])
    summary = srv.summary(res, wall, {(vocab,), (slots, vocab), (slots, k1, vocab)})
    launches = _path_launches(ck, "spec_ragged", srv)
    check(res[-1].prompt_eval_count > engine.config.prefill_chunk,
          f"quant serve: the long prompt has {res[-1].prompt_eval_count} tokens")
    engine.stop()
    steps = profile_step.profile_weights(engine)
    out = {"model": QUANT_MODEL, "quantize": "int8", "dtype": "bfloat16",
           "layers": cfg.num_layers, "load_s": load_s,
           "weights_bytes": weights, "weights_gib": weights / 2**30,
           "bf16_weights_gib": _meta_nbytes(torch, QUANT_MODEL, None) / 2**30,
           "device_total_gib": total / 2**30, "kv_pages": pages,
           "kv_pool_gib": pages * page_bytes / 2**30,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "long_prompt_tokens": res[-1].prompt_eval_count,
           "long_ttft_ms": res[-1].prompt_eval_duration_ns / 1e6,
           "chunk_and_mixed_steps": srv.calls.get("mixed_step", 0)
           + srv.calls.get("prefill_chunk", 0),
           "model_calls": dict(srv.calls), "verify_steps": engine.spec_stats["steps"],
           "launches": launches, **summary, "profiled_steps": steps}
    _free(torch, srv)
    return out


def phase_quant(torch) -> dict:
    """int8 weights (see the module docstring): the card's quantization
    bit-equal to the CPU's, qdot timed beside the bf16 product, the 2-layer
    float32 cut of llama3:70b against its forward and the unquantized
    logits, and llama3:70b int8 at all 80 layers served."""
    inp = Inputs(torch, SEED + 15)
    parts, seconds = {}, {}
    for part, fn in (("bits", lambda: _quant_bits(torch)),
                     ("timing", lambda: _quant_timing(torch, inp)),
                     ("model", lambda: _quant_model(torch)),
                     ("serve", lambda: _quant_serve(torch))):
        t0 = time.perf_counter()
        parts[part] = fn()
        seconds[part] = time.perf_counter() - t0
        print(json.dumps({"quant": part, **parts[part]}), file=sys.stderr, flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"phase": "quant", "card": card_line(), **parts, "part_seconds": seconds,
            "launches": parts["serve"]["launches"]}


# ---------------------------------------------------------------------------
# the mixtral family: mixtral:8x7b at full width (phase_mixtral)
# ---------------------------------------------------------------------------

MIXTRAL_MODEL = "mixtral:8x7b"
MIXTRAL_LAYERS = 16         # of 32: 43.7 GiB in bf16 (32 layers are 87.0 GiB)
MIXTRAL_FORM_REL = 1e-4     # the dense and ragged forms against each other, float32


def _mixtral_forms(torch) -> dict:
    """The two MoE forms of one full-width float32 mixtral layer against each
    other (relative to the output's largest) at 8, 40 and 1,024 tokens, and
    both timed in bf16 at the decode width (8 tokens) and a prefill bucket
    (1,024), beside the bytes bound of the expert weights each reads."""
    from gridllm_torch.models import mixtral as mx
    from gridllm_torch.models.configs import get_config

    cfg = get_config(MIXTRAL_MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 18)
    e, f, x = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts

    def leaves(dtype):
        lp = {"router": torch.randn(e, x, generator=gen, device="cuda") * 0.02,
              "we_gate": torch.randn(x, e, f, generator=gen, device="cuda") * e ** -0.5,
              "we_up": torch.randn(x, e, f, generator=gen, device="cuda") * e ** -0.5,
              "we_down": torch.randn(x, f, e, generator=gen, device="cuda") * f ** -0.5}
        return {k: v.to(dtype) for k, v in lp.items()}

    lp = leaves(torch.float32)
    rel = {}
    for t in (8, 40, 1024):
        xs = torch.randn(1, t, e, generator=gen, device="cuda")
        dense = mx._moe_mlp_dense(cfg, lp, xs)
        ragged = mx._moe_mlp_ragged(cfg, lp, xs)
        rel[t] = float((dense - ragged).abs().max() / dense.abs().max())
    check(max(rel.values()) <= MIXTRAL_FORM_REL, f"mixtral: the MoE forms differ by {rel}")
    del lp
    lp = leaves(torch.bfloat16)
    expert_bytes = 3 * e * f * 2
    timing = {}
    for t in (8, 1024):
        xs = torch.randn(1, t, e, generator=gen, device="cuda").to(torch.bfloat16)
        _, top_i = mx._route(cfg, lp, xs.reshape(-1, e))
        hit = int(torch.unique(top_i).numel())
        row = {"dense_ms": time_ms(torch, lambda: mx._moe_mlp_dense(cfg, lp, xs), iters=10),
               "ragged_ms": time_ms(torch, lambda: mx._moe_mlp_ragged(cfg, lp, xs), iters=10),
               "experts_hit": hit}
        flops_k = 2 * t * cfg.experts_per_token * 3 * e * f
        row["ragged_bound_ms"], row["ragged_bound_by"] = bound_ms(hit * expert_bytes, flops_k)
        row["dense_bound_ms"], row["dense_bound_by"] = bound_ms(x * expert_bytes,
                                                                2 * t * x * 3 * e * f)
        timing[t] = row
    del lp
    gc.collect()
    torch.cuda.empty_cache()
    return {"form_rel_err": rel, "form_rel_bound": MIXTRAL_FORM_REL, "timing_bf16": timing}


def _mixtral_model(torch) -> dict:
    """mixtral:8x7b cut to 2 layers at full width, float32: the paged path
    (its 16-token and larger calls in the ragged form, its decode in the
    dense form) against its cache-free forward to F32_TOL."""
    from gridllm_torch.models import mixtral as mx
    from gridllm_torch.models.configs import get_config
    from gridllm_torch.ops.kernels import F32_TOL

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(_cut(MIXTRAL_MODEL, 2))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    model = mx.Mixtral(cfg, dtype=torch.float32, device="cuda").init_params(gen)
    before = dict(mx.MOE_FORMS)
    errs = _paged_vs_forward(torch, model, SEED + 20)
    forms = {k: mx.MOE_FORMS[k] - before[k] for k in before}
    check(max(errs.values()) <= F32_TOL, f"mixtral model: paged path differs from forward "
                                          f"by {errs}")
    check(forms["dense"] > 0 and forms["ragged"] > 0, f"mixtral model: MoE forms {forms}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": f"{MIXTRAL_MODEL}, 2 layers, float32", "max_abs_err": errs,
            "bound": F32_TOL, "moe_calls": forms}


def _mixtral_serve(torch) -> dict:
    """mixtral:8x7b bf16 at full width cut to MIXTRAL_LAYERS layers, random
    weights from seed 0, the engine's defaults: the serve phase's eight
    requests plus a 2,000-byte prompt in chunks of 1,024. Launch counters
    from 0 over the run, held to the ragged path's kernels; MoE calls by
    form (the ragged form at 16 or more tokens: GRIDLLM_MOE_RAGGED auto on
    the card)."""
    import random

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.models import mixtral as mx
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.quant import params_nbytes
    from gridllm_torch.tools import profile_step

    name = _cut(MIXTRAL_MODEL, MIXTRAL_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = Served(torch, InferenceEngine(EngineConfig(model=name), device="cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    engine = srv.engine
    check(isinstance(engine.model, mx.Mixtral), "mixtral serve: the engine did not build Mixtral")
    vocab, slots, k1 = srv.vocab, engine.config.max_slots, engine.config.spec_k + 1
    engine.start()
    _, _, _, batch_a = _serve_prompts()
    long_prompt = _prompt(random.Random(SEED + 18), QUANT_LONG_BYTES)
    ck.reset_launch_counts()
    before = dict(mx.MOE_FORMS)
    res, wall = srv.run(batch_a + [(long_prompt, 32)])
    forms = {k: mx.MOE_FORMS[k] - before[k] for k in before}
    summary = srv.summary(res, wall, {(vocab,), (slots, vocab), (slots, k1, vocab)})
    launches = _path_launches(ck, "spec_ragged", srv)
    check(forms["ragged"] > 0, f"mixtral serve: no MoE call took the ragged form: {forms}")
    engine.stop()
    before = dict(mx.MOE_FORMS)
    steps = profile_step.profile_weights(engine)
    check(mx.MOE_FORMS["dense"] > before["dense"] and mx.MOE_FORMS["ragged"] > before["ragged"],
          "mixtral serve: the profiled decode and verify steps did not take both forms")
    out = {"model": MIXTRAL_MODEL, "cut": f"{MIXTRAL_LAYERS} of 32 layers, full width",
           "dtype": "bfloat16", "load_s": load_s,
           "weights_gib": params_nbytes(engine.model.params_tree()) / 2**30,
           "full_depth_gib": _meta_nbytes(torch, MIXTRAL_MODEL, None) / 2**30,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "long_prompt_tokens": res[-1].prompt_eval_count,
           "long_ttft_ms": res[-1].prompt_eval_duration_ns / 1e6,
           "moe_calls": forms, "moe_calls_per_layer": {
               k: v / MIXTRAL_LAYERS for k, v in forms.items()},
           "model_calls": dict(srv.calls), "verify_steps": engine.spec_stats["steps"],
           "launches": launches, **summary, "profiled_steps": steps}
    _free(torch, srv)
    return out


def phase_mixtral(torch) -> dict:
    """The mixtral family (see the module docstring): the two MoE forms
    against each other and timed, the 2-layer float32 cut against its
    forward, and mixtral:8x7b at 16 layers served."""
    parts, seconds = {}, {}
    for part, fn in (("forms", lambda: _mixtral_forms(torch)),
                     ("model", lambda: _mixtral_model(torch)),
                     ("serve", lambda: _mixtral_serve(torch))):
        t0 = time.perf_counter()
        parts[part] = fn()
        seconds[part] = time.perf_counter() - t0
        print(json.dumps({"mixtral": part, **parts[part]}), file=sys.stderr, flush=True)
    return {"phase": "mixtral", "card": card_line(), **parts, "part_seconds": seconds,
            "launches": parts["serve"]["launches"]}


# ---------------------------------------------------------------------------
# gateway: HTTP through the port's gateway in front of the port's scheduler
# ---------------------------------------------------------------------------

GATEWAY_WAVE_BYTES = (300, 450, 200, 600, 350, 500, 250, 400)
GATEWAY_WAVE_TOKENS = (64, 48, 56, 64, 48, 64, 56, 48)
GATEWAY_WAYS = ("a", "b", "c", "c", "b", "a")   # turns: each way twice, mirrored


async def _ndjson_stream(http, base, prompt, n, on_frame=None, model=WORKER_MODEL,
                         path="/api/generate", body=None):
    """One streamed greedy /api/generate of `prompt` (or `path` with `body`,
    /api/chat with its messages): (seconds to the first NDJSON frame, the
    text its frames put together, the final frame); `on_frame(count)` is
    awaited after each frame."""
    t0 = time.perf_counter()
    t_first, parts, last, frames = None, [], None, 0
    async with http.post(base + path, json={
            "model": model, **(body or {"prompt": prompt}),
            "options": {"temperature": 0, "num_predict": n}}) as r:
        check(r.status == 200, f"{base}{path}: stream status {r.status}")
        async for line in r.content:
            if not line.strip():
                continue
            frame = json.loads(line)
            frames += 1
            if t_first is None:
                t_first = time.perf_counter()
            if frame.get("done"):
                last = frame
            else:
                parts.append(frame.get("response")
                             or (frame.get("message") or {}).get("content") or "")
            if on_frame is not None:
                await on_frame(frames)
    check(last is not None and "error" not in last, f"{base}{path}: stream ended {last}")
    return t_first - t0, "".join(parts), last


class _GatewayStack:
    """The port's GatewayServer (local control plane) on the port's
    InMemoryBus, bound to 127.0.0.1:0, with one port WorkerService on
    `engine` (as WORKER_MODEL, or the engines of `models` by name) behind
    it and an aiohttp client session."""

    def __init__(self, engine, worker_id, models=None):
        self.engine, self.worker_id = engine, worker_id
        self.models = models or {WORKER_MODEL: engine}

    async def __aenter__(self):
        import aiohttp

        from gridllm_torch.bus import InMemoryBus
        from gridllm_torch.gateway import GatewayServer
        from gridllm_torch.utils.config import Config, SchedulerConfig, WorkerConfig
        from gridllm_torch.worker.service import WorkerService

        config = Config(scheduler=SchedulerConfig(sweep_interval_ms=200))
        config.gateway.host = "127.0.0.1"
        config.gateway.rate_limit_max_requests = 100_000
        self.server = GatewayServer(config, bus=InMemoryBus())
        self.port = await self.server.start(0)
        self.base = f"http://127.0.0.1:{self.port}"
        self.worker = WorkerService(self.server.bus, self.models,
                                    WorkerConfig(worker_id=self.worker_id,
                                                 heartbeat_interval_ms=1000),
                                    stream_flush_ms=20)
        await self.worker.start()
        await _wait(lambda: self.server.registry.get_worker(self.worker_id) is not None,
                    "gateway: the worker registered")
        self.http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))
        return self

    async def __aexit__(self, *exc):
        await self.http.close()
        await self.worker.stop(announce=False)
        await self.server.shutdown()

    async def call(self, method, path, body=None, data=None):
        """(status, content type, body): JSON parsed, NDJSON and SSE as lists
        of frames, anything else as text."""
        kw = {"json": body} if data is None else {"data": data}
        async with self.http.request(method, self.base + path, **kw) as r:
            text = await r.text()
            ctype = r.headers.get("Content-Type", "")
        if ctype.startswith("application/json"):
            return r.status, ctype, json.loads(text)
        if ctype.startswith("application/x-ndjson"):
            return r.status, ctype, [json.loads(ln) for ln in text.splitlines() if ln]
        if ctype.startswith("text/event-stream"):
            frames = [f[len("data: "):] for f in text.split("\n\n") if f]
            return r.status, ctype, [f if f == "[DONE]" else json.loads(f) for f in frames]
        return r.status, ctype, text

    async def stream_generate(self, prompt, n):
        return await _ndjson_stream(self.http, self.base, prompt, n)


def _gateway_req(rid, prompt, n):
    from gridllm_torch.utils.types import InferenceRequest

    return InferenceRequest(id=rid, model=WORKER_MODEL, prompt=prompt, stream=True,
                            options={"temperature": 0, "num_predict": n},
                            metadata={"requestType": "inference"})


async def _gateway_way(way, st, standin, direct_id, prompts, tag) -> dict:
    """The eight streams one way: (a) a bus client straight to a worker,
    (b) the port's JobScheduler.submit_streaming_job, (c) HTTP through the
    port's gateway. TTFT is the client's submit to its first frame."""
    import asyncio

    t0 = time.perf_counter()
    if way == "a":
        jobs = [await standin.submit(direct_id, _worker_request(f"{tag}-{i}", n, prompt=p))
                for i, (p, n) in enumerate(zip(prompts, GATEWAY_WAVE_TOKENS))]
        served = [await asyncio.wait_for(j.result, 600) for j in jobs]
        for j, res in zip(jobs, served):
            check(res.success and j.t_first is not None, f"gateway (a): {res.error}")
        ttft = [j.t_first - j.t_submit for j in jobs]
        tokens = [r.response.eval_count for r in served]
    elif way == "b":
        async def one(i, p, n):
            first: list[float] = []

            async def on_chunk(c):
                if not first and (c.response or (c.message or {}).get("content")):
                    first.append(time.perf_counter())

            t = time.perf_counter()
            res = await st.server.scheduler.submit_streaming_job(
                _gateway_req(f"{tag}-{i}", p, n), on_chunk, timeout_ms=600_000)
            check(res.success and first, f"gateway (b): {res.error}")
            return first[0] - t, res.response.eval_count

        got = await asyncio.gather(*[one(i, p, n) for i, (p, n)
                                     in enumerate(zip(prompts, GATEWAY_WAVE_TOKENS))])
        ttft, tokens = [g[0] for g in got], [g[1] for g in got]
    else:
        got = await asyncio.gather(*[st.stream_generate(p, n)
                                     for p, n in zip(prompts, GATEWAY_WAVE_TOKENS)])
        ttft, tokens = [g[0] for g in got], [g[2]["eval_count"] for g in got]
    wall = time.perf_counter() - t0
    return {"ttft_s": ttft, "tokens": sum(tokens), "wall_s": wall}


async def _gateway_serve(torch, engine) -> dict:
    """The bf16 part: warm-up, then with the launch counters from 0 every
    surface once and the wave three ways in turns."""
    import asyncio
    import random

    from gridllm_torch.bus import InMemoryBus
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker.service import WorkerService

    rng = random.Random(SEED + 21)
    # way (a): a second WorkerService on the same engine, on a bus of its
    # own with the stand-in scheduler of the worker phase
    abus = InMemoryBus()
    await abus.connect()
    standin = _StandIn(abus)
    await standin.start()
    direct = WorkerService(abus, {WORKER_MODEL: engine},
                           WorkerConfig(worker_id=f"{WORKER_ID}-direct",
                                        heartbeat_interval_ms=1000), stream_flush_ms=20)
    await direct.start()
    try:
        async with _GatewayStack(engine, f"{WORKER_ID}-gw") as st:
            gen = {"model": WORKER_MODEL, "stream": False,
                   "options": {"temperature": 0, "num_predict": 8}}
            for n in (300, 1500):   # warm-up, not measured
                s, _, b = await st.call("POST", "/api/generate", {**gen, "prompt": _prompt(rng, n)})
                check(s == 200 and b.get("done"), f"gateway: warm-up {s} {b}")
            ck.reset_launch_counts()
            with _PlainWatch(torch) as plain:
                surfaces = await _gateway_surfaces(st, rng)
                ways: dict[str, list] = {w: [] for w in "abc"}
                for turn, way in enumerate(GATEWAY_WAYS):
                    prompts = [_prompt(rng, n) for n in GATEWAY_WAVE_BYTES]
                    ways[way].append(await _gateway_way(way, st, standin, direct.worker_id,
                                                        prompts, f"{way}{turn}"))
                s, _, b = await surfaces.pop("cancelled_inference")
                check(s == 504 and b["error"]["code"] == "JOB_TIMEOUT",
                      f"gateway: the cancelled /inference answered {s} {b}")
                await _wait(lambda: not engine.active_requests and not engine.queued_requests,
                            "gateway: the engine idle")
                launches = ck.launch_counts()
            _, _, metrics = await st.call("GET", "/metrics")
    finally:
        await direct.stop(announce=False)
        await abus.disconnect()
    check(not any(plain.counts.values()), f"gateway: a plain version ran: {plain.counts}")
    for name in ("flash_prefill", "ragged_attention", "ragged_attention.chunk",
                 "ragged_attention.group", "paged_write_decode", "paged_write_chunk"):
        check(launches.get(name, 0) > 0, f"gateway: {name} never launched: {launches}")
    for route, status in surfaces.pop("routes_hit"):
        check(f'route="{route}"' in metrics and any(
            f'route="{route}"' in ln and f'status="{status}"' in ln
            for ln in metrics.splitlines() if ln.startswith("gridllm_gateway_requests_total{")),
            f"gateway: /metrics has no request count for {route} {status}")
    out = {}
    for way, runs in ways.items():
        ttft = [t * 1e3 for r in runs for t in r["ttft_s"]]
        tokens = sum(r["tokens"] for r in runs)
        wall = sum(r["wall_s"] for r in runs)
        out[way] = {"jobs": len(ttft), "ttft_ms_p50": _pct(ttft, 0.5),
                    "ttft_ms_p90": _pct(ttft, 0.9), "output_tokens": tokens, "wall_s": wall,
                    "output_tokens_per_s": tokens / wall}
    return {"ways": out, "surfaces": surfaces, "launches": launches,
            "plain_calls_on_card": plain.counts}


async def _gateway_surfaces(st, rng) -> dict:
    """Every surface once, status codes and bodies checked; returns what
    was read, the (route, status) pairs /metrics must count, and the task
    of the /inference job cancelled mid-generation (its waiter times out
    with 504 while the wave runs)."""
    import asyncio

    m = WORKER_MODEL
    greedy = {"temperature": 0, "num_predict": 16}
    hit: list[tuple[str, str]] = []
    out: dict = {}

    async def call(route, method, path, body=None, status=200, data=None):
        s, ctype, b = await st.call(method, path, body, data=data)
        check(s == status, f"gateway: {method} {path} answered {s}, want {status}: {b}")
        hit.append((route, str(s)))
        return ctype, b

    for prefix in ("/api", "/ollama/api"):
        _, b = await call(f"{prefix}/generate", "POST", f"{prefix}/generate",
                          {"model": m, "prompt": _prompt(rng, 1500), "stream": False,
                           "options": greedy})
        check(b["done"] and b["eval_count"] == 16 and b["done_reason"] == "length",
              f"gateway: {prefix}/generate {b}")
        ctype, frames = await call(f"{prefix}/generate", "POST", f"{prefix}/generate",
                                   {"model": m, "prompt": _prompt(rng, 300), "options": greedy})
        check(ctype.startswith("application/x-ndjson") and frames[-1]["done"]
              and frames[-1]["eval_count"] == 16 and not any(f["done"] for f in frames[:-1]),
              f"gateway: {prefix}/generate stream {frames[-1]}")
    ctype, frames = await call("/api/chat", "POST", "/api/chat", {
        "model": m, "options": greedy, "messages": [{"role": "user", "content": "hi there"}]})
    check(frames[-1]["done"] and all(f["message"]["role"] == "assistant" for f in frames),
          f"gateway: /api/chat stream {frames[-1]}")
    chat = {"model": m, "max_tokens": 16, "temperature": 0,
            "messages": [{"role": "user", "content": _prompt(rng, 200)}]}
    ctype, frames = await call("/v1/chat/completions", "POST", "/v1/chat/completions",
                               {**chat, "stream": True})
    check(ctype.startswith("text/event-stream") and frames[-1] == "[DONE]"
          and frames[-2]["choices"][0]["finish_reason"] == "length"
          and frames[0]["choices"][0]["delta"].get("role") == "assistant",
          f"gateway: /v1/chat/completions stream {frames[-3:]}")
    _, b = await call("/v1/chat/completions", "POST", "/v1/chat/completions", chat)
    check(b["object"] == "chat.completion" and b["usage"]["completion_tokens"] == 16,
          f"gateway: /v1/chat/completions {b}")
    _, b = await call("/v1/completions", "POST", "/v1/completions",
                      {"model": m, "prompt": _prompt(rng, 200), "max_tokens": 16,
                       "temperature": 0})
    check(b["object"] == "text_completion" and b["usage"]["completion_tokens"] == 16,
          f"gateway: /v1/completions {b}")
    # the native API: a short job for its trace, then one cancelled mid-generation
    _, b = await call("/inference", "POST", "/inference",
                      {"model": m, "prompt": _prompt(rng, 250), "options": greedy})
    traced = b["id"]
    check(b["done"] and b["eval_count"] == 16, f"gateway: /inference {b}")
    task = asyncio.ensure_future(st.call("POST", "/inference", {
        "model": m, "prompt": _prompt(rng, 250), "timeout": 10_000,
        "options": {"temperature": 0, "num_predict": 400}}))
    await _wait(lambda: any(a.request.metadata.get("endpoint") == "/inference"
                            for a in st.server.scheduler.get_active_jobs()),
                "gateway: the /inference job assigned")
    (job,) = [a.jobId for a in st.server.scheduler.get_active_jobs()
              if a.request.metadata.get("endpoint") == "/inference"]
    # mid-generation: the worker's snapshots hold decoded tokens (a cancel
    # that beats the assignment to the engine would find nothing to stop)
    await _wait(lambda: len(st.server.scheduler._resume_snap.get(job, {}).get("tokens", ()))
                >= 8, "gateway: the /inference job decoding")
    _, b = await call("/inference/{job_id}/status", "GET", f"/inference/{job}/status")
    check(b["status"] == "processing", f"gateway: /inference status {b}")
    _, b = await call("/inference/{job_id}", "DELETE", f"/inference/{job}")
    check(b == {"id": job, "status": "cancelled"}, f"gateway: DELETE /inference {b}")
    out["cancelled_inference"] = task
    _, b = await call("/health", "GET", "/health")
    check(b["status"] == "healthy", f"gateway: /health {b}")
    _, b = await call("/health/workers", "GET", "/health/workers")
    check([(w["workerId"], w["status"], m in w["models"]) for w in b["workers"]]
          == [(st.worker_id, "online", True)], f"gateway: /health/workers {b}")
    _, b = await call("/api/tags", "GET", "/api/tags")
    check(m in [t["name"] for t in b["models"]], f"gateway: /api/tags {b}")
    _, b = await call("/v1/models", "GET", "/v1/models")
    check(m in [d["id"] for d in b["data"]], f"gateway: /v1/models {b}")
    _, b = await call("/api/generate", "POST", "/api/generate",
                      {"model": "no-such-model", "prompt": "x", "stream": False}, status=404)
    check(b["error"]["code"] == "MODEL_NOT_FOUND", f"gateway: unknown model {b}")
    _, b = await call("/api/generate", "POST", "/api/generate", data=b"{not json", status=400)
    check(b["error"]["code"] == "BAD_JSON", f"gateway: malformed body {b}")
    # the trace: gateway.request through scheduler.dispatch to the worker's spans
    names: set = set()
    for _ in range(200):
        _, b = await call("/admin/trace/{request_id}", "GET", f"/admin/trace/{traced}")
        names = {s["name"] for s in b["spans"]}
        if {"worker.execute", "engine.decode"} <= names:
            break
        await asyncio.sleep(0.05)
    check({"gateway.request", "scheduler.dispatch", "worker.execute", "engine.prefill",
           "engine.decode"} <= names and "gateway" in b["sources"]
          and any(src.startswith("worker:") for src in b["sources"]),
          f"gateway: /admin/trace spans {sorted(names)} from {b['sources']}")
    out["trace_spans"] = sorted(names)
    out["routes_hit"] = sorted(set(hit))
    return out


async def _gateway_f32(engine) -> dict:
    """The 8-layer float32 cut: greedy /api/generate through the gateway,
    then the same request through the scheduler's submit_and_wait on the
    same engine (a warm prefix-cache replay, exact in float32): the same
    text and eval count."""
    import random

    from gridllm_torch.utils.types import InferenceRequest

    prompt = _prompt(random.Random(SEED + 22), 400)
    async with _GatewayStack(engine, f"{WORKER_ID}-f32") as st:
        s, _, http = await st.call("POST", "/api/generate", {
            "model": WORKER_MODEL, "prompt": prompt, "stream": False,
            "options": {"temperature": 0, "num_predict": 48}})
        check(s == 200, f"gateway f32: /api/generate {s} {http}")
        res = await st.server.scheduler.submit_and_wait(InferenceRequest(
            id="f32-sched", model=WORKER_MODEL, prompt=prompt, stream=False,
            options={"temperature": 0, "num_predict": 48},
            metadata={"requestType": "inference"}), timeout_ms=600_000)
        check(res.success, f"gateway f32: submit_and_wait {res.error}")
    check(http["response"] == res.response.response
          and http["eval_count"] == res.response.eval_count == 48,
          "gateway f32: the HTTP text differs from the scheduler's")
    return {"equal": True, "eval_count": http["eval_count"], "chars": len(http["response"])}


def phase_gateway(torch) -> dict:
    """HTTP through the port's gateway (GatewayServer, local control plane,
    on the port's InMemoryBus at 127.0.0.1:0) in front of the port's
    scheduler and one port WorkerService on llama3:8b bf16, all 32 layers,
    the engine's defaults: after two warm-up jobs, with the launch counters
    from 0, every surface once (Ollama generate under /api and
    /ollama/api, streamed and not, chat streamed, /v1/chat/completions
    over SSE and not, /v1/completions, /inference with its status and a
    DELETE mid-generation, /health, /health/workers, /api/tags, /v1/models,
    /metrics counting each route and status, /admin/trace from
    gateway.request through scheduler.dispatch to the worker's spans, an
    unknown model 404, a malformed body 400), then eight concurrent
    streamed generations of 48-64 tokens three ways in turns (a, b, c, c,
    b, a), each turn with fresh prompts of the same lengths: (a) a bus
    client straight to a WorkerService on the same engine, (b) the
    scheduler's submit_streaming_job, (c) streamed /api/generate over HTTP;
    TTFT p50/p90 and output tokens/s per way; the main kernels launched, no
    plain version. Then on the 8-layer float32 cut, greedy /api/generate
    byte-identical to the scheduler's submit_and_wait."""
    import asyncio

    engine = _kvx_engine(torch)
    out = asyncio.run(_gateway_serve(torch, engine))
    check(not engine.running, "gateway: the engine's runner did not stop")
    del engine
    engine = _kvx_engine(torch, model=_kvx_f32_model(), dtype="float32")
    with _PlainWatch(torch) as plain:
        out["f32_http_equals_scheduler"] = asyncio.run(_gateway_f32(engine))
    check(not any(plain.counts.values()), f"gateway f32: a plain version ran: {plain.counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    print(json.dumps({"gateway_ways": {w: {k: v[k] for k in ("ttft_ms_p50", "ttft_ms_p90",
                                                             "output_tokens_per_s")}
                                       for w, v in out["ways"].items()}, "card": card}),
          flush=True)
    return {"phase": "gateway", "model": WORKER_MODEL, "dtype": "bfloat16", "card": card, **out}


# ---------------------------------------------------------------------------
# controlplane: the scaled control plane, each member a process of its own
# ---------------------------------------------------------------------------

CP_TTL_MS, CP_RENEW_MS, CP_STATUS_MS = 2000, 400, 200
CP_WAYS = ("d", "e", "e", "d")   # turns: each way twice, mirrored
CP_KILL_AFTER_FRAMES = 5
CP_F32_TOKENS = 320   # ~6 s on the float32 cut: still decoding when the adoption lands
CP_MEMBERS = ["gw-0", "gw-1", "shard-0", "shard-1"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Procs:
    """The control plane's processes, each `python -m <entry point>` from
    this checkout with its output in chiprun_out/controlplane_<name>.txt;
    every one still running is stopped (SIGTERM, then SIGKILL) on exit."""

    def __init__(self):
        self.procs: dict = {}
        self.out = REPO / "chiprun_out"
        self.out.mkdir(exist_ok=True)

    def start(self, name, module, *args, env=None):
        import os

        log = open(self.out / f"controlplane_{name}.txt", "w")
        proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=REPO,
                                env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})},
                                stdout=log, stderr=subprocess.STDOUT)
        self.procs[name] = (proc, log)

    def check_alive(self, *names) -> None:
        for name in names or self.procs:
            proc, _ = self.procs[name]
            check(proc.poll() is None, f"controlplane: {name} exited with {proc.returncode}: "
                                       f"see chiprun_out/controlplane_{name}.txt")

    def kill(self, name) -> None:
        import signal

        proc, _ = self.procs[name]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        import signal

        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc, log in self.procs.values():
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)
            log.close()


def _wait_listening(port: int, what: str, timeout_s: float = 30.0) -> None:
    import socket

    t0 = time.perf_counter()
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            check(time.perf_counter() - t0 < timeout_s, f"controlplane: {what} never listened")
            time.sleep(0.05)


async def _http_json(http, url, body=None):
    """(status, JSON body or None) of a GET (or a POST of `body`)."""
    import aiohttp

    try:
        call = http.get(url) if body is None else http.post(url, json=body)
        async with call as r:
            return r.status, (await r.json() if r.content_type == "application/json" else
                              await r.text())
    except aiohttp.ClientError:
        return None, None


class _Assignments:
    """Every job_assignment published to a worker's job channel, by job id,
    read by a subscriber of its own on the broker."""

    def __init__(self, bus, worker_id):
        self.bus, self.worker_id, self.jobs = bus, worker_id, []

    async def start(self):
        from gridllm_torch.bus.base import worker_job_channel

        async def on_job(_ch, raw):
            msg = json.loads(raw)
            if msg.get("type") == "job_assignment":
                self.jobs.append(msg["job"]["jobId"])

        self.sub = await self.bus.subscribe(worker_job_channel(self.worker_id), on_job)


async def _cp_surfaces(http, replicas, shard_ports, rng) -> dict:
    """Every fleet surface once through a replica, and /api/generate
    through each (prompts longer than a prefill chunk: mixed steps)."""
    out: dict = {}
    for i, base in enumerate(replicas):
        s, b = await _http_json(http, base + "/api/generate", {
            "model": WORKER_MODEL, "prompt": _prompt(rng, 1500), "stream": False,
            "options": {"temperature": 0, "num_predict": 16}})
        check(s == 200 and b["done"] and b["eval_count"] == 16,
              f"controlplane: /api/generate through replica {i}: {s} {b}")
    base = replicas[0]
    s, b = await _http_json(http, base + "/health/workers")
    cp = (b or {}).get("controlPlane") or {}
    check(s == 200 and cp.get("numShards") == 2 and sorted(cp.get("members", {})) == CP_MEMBERS
          and [w["workerId"] for w in b["workers"]] == ["cp-worker"],
          f"controlplane: /health/workers {s} {b}")
    out["health_workers"] = {"numShards": cp["numShards"], "members": sorted(cp["members"]),
                             "shards": {m: e["shards"] for m, e in cp["members"].items()}}
    s, b = await _http_json(http, base + "/admin/slo")
    check(s == 200 and sorted(b.get("fleet", {})) == CP_MEMBERS,
          f"controlplane: /admin/slo {s} {b}")
    s, b = await _http_json(http, base + "/admin/capacity")
    check(s == 200 and sorted(b.get("fleet", {}).get("perMember", {})) == CP_MEMBERS
          and b["fleet"]["numShards"] == 2, f"controlplane: /admin/capacity {s} {b}")
    s, b = await _http_json(http, base + "/admin/dump?fleet=1")
    check(s == 200 and b["fleet"]["requested"] == CP_MEMBERS and not b["fleet"]["missing"]
          and sorted(b["fleet"]["members"]) == CP_MEMBERS,
          f"controlplane: /admin/dump?fleet=1 {s} {b.get('fleet', {}).get('requested')}")
    out["dump_members"] = sorted(b["fleet"]["members"])
    async with http.get(base + "/metrics") as r:
        text = await r.text()
    held = {ln.split('shard="')[1].split('"')[0]: float(ln.rsplit(" ", 1)[1])
            for ln in text.splitlines() if ln.startswith("gridllm_shard_lease_held{")}
    check(held == {"0": 1.0, "1": 1.0}, f"controlplane: gridllm_shard_lease_held {held}")
    out["lease_held"] = held
    for i, port in enumerate(shard_ports):
        s, b = await _http_json(http, f"http://127.0.0.1:{port}/health/live")
        check(s == 200 and b["shards"] == [i], f"controlplane: shard {i} /health/live {b}")
    return out


async def _cp_way(way, http, local_base, replicas, prompts) -> dict:
    """Eight concurrent streamed /api/generate one way: (d) the local-mode
    gateway in this process, (e) the scaled fleet, split across its two
    replicas."""
    import asyncio

    t0 = time.perf_counter()
    bases = [local_base] * len(prompts) if way == "d" else \
        [replicas[i % len(replicas)] for i in range(len(prompts))]
    got = await asyncio.gather(*[_ndjson_stream(http, b, p, n) for b, p, n
                                 in zip(bases, prompts, GATEWAY_WAVE_TOKENS)])
    return {"ttft_s": [g[0] for g in got], "tokens": sum(g[2]["eval_count"] for g in got),
            "wall_s": time.perf_counter() - t0}


async def _cp_serve(torch, engine, procs, ports) -> dict:
    """The bf16 part: both ways' stacks on the engine, warm-up, then with
    the launch counters from 0 every fleet surface and the waves in turns."""
    import asyncio
    import random

    import aiohttp

    from gridllm_torch.bus import create_bus
    from gridllm_torch.gateway import GatewayServer
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.utils.config import Config, SchedulerConfig, WorkerConfig
    from gridllm_torch.worker.service import WorkerService

    rng = random.Random(SEED + 23)
    replicas = [f"http://127.0.0.1:{p}" for p in ports["replicas"]]
    # (e): the fleet's worker on the fleet's broker
    ebus = create_bus(f"resp://127.0.0.1:{ports['broker_e']}")
    await ebus.connect()
    fleet_worker = WorkerService(ebus, {WORKER_MODEL: engine},
                                 WorkerConfig(worker_id="cp-worker", heartbeat_interval_ms=1000),
                                 stream_flush_ms=20)
    # (d): a local-mode gateway and a worker of its own on the same engine,
    # on the second broker (channels carry no key prefix: on one broker the
    # two stacks would see each other's workers)
    config = Config(scheduler=SchedulerConfig(sweep_interval_ms=200))
    config.gateway.host = "127.0.0.1"
    config.gateway.rate_limit_max_requests = 100_000
    local = GatewayServer(config, bus=create_bus(f"resp://127.0.0.1:{ports['broker_d']}"))
    local_port = await local.start(0)
    local_base = f"http://127.0.0.1:{local_port}"
    local_worker = WorkerService(local.bus, {WORKER_MODEL: engine},
                                 WorkerConfig(worker_id="cp-local", heartbeat_interval_ms=1000),
                                 stream_flush_ms=20)
    out: dict = {}
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
            t0 = time.perf_counter()
            for i, port in enumerate(ports["shard_health"]):
                while (await _http_json(http, f"http://127.0.0.1:{port}/health/live"))[0] != 200:
                    procs.check_alive()
                    check(time.perf_counter() - t0 < 60, f"controlplane: shard {i} never up")
                    await asyncio.sleep(0.05)
            await fleet_worker.start()
            await local_worker.start()
            await _wait(lambda: local.registry.get_worker("cp-local") is not None,
                        "controlplane: the local worker registered")
            for base in replicas:
                while True:
                    procs.check_alive()
                    s, b = await _http_json(http, base + "/health/workers")
                    if s == 200 and [w["workerId"] for w in b["workers"]] == ["cp-worker"] and \
                            sorted((b.get("controlPlane") or {}).get("members", {})) == CP_MEMBERS:
                        break
                    check(time.perf_counter() - t0 < 60, f"controlplane: {base} never saw "
                                                         f"the fleet: {b}")
                    await asyncio.sleep(0.05)
            out["ready_s"] = time.perf_counter() - t0
            for base in (local_base, *replicas):   # warm-up, not measured
                await _ndjson_stream(http, base, _prompt(rng, 1500), 8)
            await _wait(lambda: not engine.active_requests and not engine.queued_requests,
                        "controlplane: the engine idle after the warm-up")
            ck.reset_launch_counts()
            with _PlainWatch(torch) as plain:
                out["surfaces"] = await _cp_surfaces(http, replicas, ports["shard_health"], rng)
                ways: dict[str, list] = {"d": [], "e": []}
                for way in CP_WAYS:
                    prompts = [_prompt(rng, n) for n in GATEWAY_WAVE_BYTES]
                    ways[way].append(await _cp_way(way, http, local_base, replicas, prompts))
                await _wait(lambda: not engine.active_requests and not engine.queued_requests,
                            "controlplane: the engine idle")
                launches = ck.launch_counts()
            procs.check_alive()
    finally:
        await local_worker.stop(announce=False)
        await local.shutdown()
        await fleet_worker.stop()
        await ebus.disconnect()
    check(not any(plain.counts.values()), f"controlplane: a plain version ran: {plain.counts}")
    for name in ("flash_prefill", "ragged_attention", "ragged_attention.chunk",
                 "ragged_attention.group", "paged_write_decode", "paged_write_chunk"):
        check(launches.get(name, 0) > 0, f"controlplane: {name} never launched: {launches}")
    out["ways"] = {}
    for way, runs in ways.items():
        ttft = [t * 1e3 for r in runs for t in r["ttft_s"]]
        tokens = sum(r["tokens"] for r in runs)
        wall = sum(r["wall_s"] for r in runs)
        out["ways"][way] = {"jobs": len(ttft), "ttft_ms_p50": _pct(ttft, 0.5),
                            "ttft_ms_p90": _pct(ttft, 0.9), "output_tokens": tokens,
                            "wall_s": wall, "output_tokens_per_s": tokens / wall}
    out["launches"] = launches
    out["plain_calls_on_card"] = plain.counts
    return out


async def _cp_kill(engine, procs, ports) -> dict:
    """The float32 cut behind the fleet: an undisturbed greedy stream
    through replica 1, then the same request again with the shard that owns
    its job (read from the shards' /admin/dump) SIGKILLed after the 5th
    frame. The stream must equal the undisturbed one byte for byte, the
    survivor adopt the partition at epoch 2, the worker be assigned the job
    once with nothing orphaned, and a second request on the adopted
    partition be served through replica 0."""
    import asyncio
    import random

    import aiohttp

    from gridllm_torch.bus import create_bus
    from gridllm_torch.controlplane.partition import shard_of
    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker.service import WorkerService

    replicas = [f"http://127.0.0.1:{p}" for p in ports["replicas"]]
    shard_urls = [f"http://127.0.0.1:{p}" for p in ports["shard_health"]]
    prompt = _prompt(random.Random(SEED + 24), 400)
    wbus = create_bus(f"resp://127.0.0.1:{ports['broker_e']}")
    sbus = create_bus(f"resp://127.0.0.1:{ports['broker_e']}")
    await wbus.connect()
    await sbus.connect()
    assigned = _Assignments(sbus, "cp-f32")
    await assigned.start()
    worker = WorkerService(wbus, {WORKER_MODEL: engine},
                           WorkerConfig(worker_id="cp-f32", heartbeat_interval_ms=500),
                           stream_flush_ms=20)
    out: dict = {}
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
            await worker.start()
            t0 = time.perf_counter()
            for base in replicas:
                while True:
                    s, b = await _http_json(http, base + "/health/workers")
                    if s == 200 and "cp-f32" in [w["workerId"] for w in b["workers"]]:
                        break
                    check(time.perf_counter() - t0 < 30, f"controlplane f32: {base} {b}")
                    await asyncio.sleep(0.05)
            _, ref_text, ref_last = await _ndjson_stream(http, replicas[1], prompt,
                                                         CP_F32_TOKENS)
            kill: dict = {}
            adopted = asyncio.get_running_loop().create_future()

            async def survivor_holds_both(url):
                while True:
                    s, b = await _http_json(http, url + "/health/live")
                    if s == 200 and b["shards"] == [0, 1]:
                        adopted.set_result(time.perf_counter())
                        # the adopter replayed the live assignment
                        _, dump = await _http_json(http, url + "/admin/dump")
                        kill["active_at_adoption"] = kill["job"] in dump["scheduler"]["active"]
                        return
                    check(time.perf_counter() - kill["t"] < 30,
                          f"controlplane f32: no adoption, survivor {b}")
                    await asyncio.sleep(0.01)

            async def on_frame(n):
                if n != CP_KILL_AFTER_FRAMES:
                    return
                job = assigned.jobs[-1]
                owners = []
                for i, url in enumerate(shard_urls):
                    _, dump = await _http_json(http, url + "/admin/dump")
                    if job in dump["scheduler"]["active"]:
                        owners.append(i)
                check(owners == [shard_of(job, 2)], f"controlplane f32: owners {owners} of "
                                                    f"{job} (shard_of {shard_of(job, 2)})")
                kill.update(job=job, owner=owners[0], t=time.perf_counter())
                procs.kill(f"shard-{owners[0]}")
                kill["task"] = asyncio.ensure_future(
                    survivor_holds_both(shard_urls[1 - owners[0]]))

            _, text, last = await _ndjson_stream(http, replicas[1], prompt, CP_F32_TOKENS,
                                                 on_frame=on_frame)
            check("job" in kill, "controlplane f32: the stream ended before the kill")
            t_adopt = await asyncio.wait_for(adopted, 60)
            await kill["task"]
            check(kill["active_at_adoption"], "controlplane f32: the job was not live on the "
                                              "survivor when it adopted the partition")
            check(text == ref_text and last["eval_count"] == ref_last["eval_count"],
                  "controlplane f32: the stream through the killed shard differs from the "
                  "undisturbed one")
            survivor = shard_urls[1 - kill["owner"]]
            _, dump = await _http_json(http, survivor + "/admin/dump")
            epochs = dump["scheduler"]["stats"]["shard"]["epochs"]
            check(epochs == {str(kill["owner"]): 2, str(1 - kill["owner"]): 1},
                  f"controlplane f32: survivor epochs {epochs}")
            async with http.get(survivor + "/metrics") as r:
                metrics = await r.text()
            orphaned = sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                           if ln.startswith("gridllm_jobs_total{") and 'event="orphaned"' in ln)
            runs = assigned.jobs.count(kill["job"])
            check(runs == 1 and orphaned == 0,
                  f"controlplane f32: {runs} assignments of the job, {orphaned} orphaned")
            second = None
            for attempt in range(12):   # until a job id lands on the adopted partition
                s, b = await _http_json(http, replicas[0] + "/api/generate", {
                    "model": WORKER_MODEL, "prompt": f"adopted {attempt}", "stream": False,
                    "options": {"temperature": 0, "num_predict": 8}})
                check(s == 200 and b["eval_count"] == 8,
                      f"controlplane f32: replica 0 after the kill {s} {b}")
                if shard_of(assigned.jobs[-1], 2) == kill["owner"]:
                    second = {"attempts": attempt + 1, "job": assigned.jobs[-1]}
                    break
            check(second is not None, "controlplane f32: no job landed on the adopted partition")
            async with http.get(survivor + "/metrics") as r:
                metrics = await r.text()
            fenced = sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                         if ln.startswith("gridllm_shard_fenced_ops_total{"))
            check(fenced == 0, f"controlplane f32: the survivor refused {fenced} operations "
                               "on a stale lease")
            out = {"equals_undisturbed": True, "eval_count": last["eval_count"],
                   "killed_shard": kill["owner"], "job": kill["job"],
                   "adoption_s": t_adopt - kill["t"], "epochs": epochs,
                   "active_at_adoption": True, "assignments": runs, "orphaned": orphaned,
                   "fenced_ops": fenced,
                   "second_on_adopted_partition": second}
    finally:
        await worker.stop(announce=False)
        await wbus.disconnect()
        await sbus.disconnect()
    return out


def phase_controlplane(torch) -> dict:
    """The scaled control plane through the port's own entry points, each a
    process: two brokers (python -m gridllm_torch.bus.broker with --aof),
    two scheduler shards (python -m gridllm_torch.controlplane,
    GRIDLLM_SHARD_COUNT=2, leases of CP_TTL_MS renewed every CP_RENEW_MS)
    and two gateway replicas (GRIDLLM_CONTROLPLANE=gateway python -m
    gridllm_torch.gateway) on the first broker; in this process the port's
    WorkerService on llama3:8b bf16 (all 32 layers, the engine's defaults)
    on that broker, and a local-mode GatewayServer with a WorkerService of
    its own on the same engine on the second broker. Every fleet surface
    once through a replica, then eight concurrent streamed /api/generate
    of 48-64 tokens two ways in turns (d, e, e, d), fresh prompts each
    turn: (d) the local gateway, (e) the fleet, split across its replicas
    (TTFT p50/p90, output tokens/s per way); launch counters from 0 held to
    the ragged path, no plain version. Then on the 8-layer float32 cut a
    greedy stream through replica 1 with its owning shard SIGKILLed after
    the 5th frame: byte-identical to the undisturbed stream, the survivor
    at epoch 2 on the killed partition with the job live there, one
    assignment, nothing orphaned, a second request on the adopted
    partition through replica 0, no operation refused on a stale lease;
    the adoption's seconds from the kill."""
    import asyncio
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="gridbus-"))
    ports = {"broker_e": _free_port(), "broker_d": _free_port(),
             "shard_health": [_free_port(), _free_port()],
             "replicas": [_free_port(), _free_port()]}
    fleet_env = {"GRIDLLM_BUS_URL": f"resp://127.0.0.1:{ports['broker_e']}",
                 "GRIDLLM_SHARD_COUNT": "2", "GRIDLLM_SHARD_LEASE_TTL_MS": str(CP_TTL_MS),
                 "GRIDLLM_SHARD_RENEW_MS": str(CP_RENEW_MS),
                 "GRIDLLM_SHARD_STATUS_MS": str(CP_STATUS_MS),
                 "SCHEDULER_SWEEP_INTERVAL": "200", "RATE_LIMIT_MAX_REQUESTS": "100000"}
    try:
        with _Procs() as procs:
            for name in ("broker_e", "broker_d"):
                procs.start(name, "gridllm_torch.bus.broker", "--host", "127.0.0.1",
                            "--port", str(ports[name]), "--aof", str(tmp / f"{name}.aof"))
            for name in ("broker_e", "broker_d"):
                _wait_listening(ports[name], name)
            for i in range(2):
                procs.start(f"shard-{i}", "gridllm_torch.controlplane", env={
                    **fleet_env, "GRIDLLM_SHARD_ID": str(i), "GRIDLLM_CONTROLPLANE_ID": f"shard-{i}",
                    "GRIDLLM_SHARD_HEALTH_PORT": str(ports["shard_health"][i])})
                procs.start(f"gw-{i}", "gridllm_torch.gateway", env={
                    **fleet_env, "GRIDLLM_CONTROLPLANE": "gateway",
                    "GRIDLLM_CONTROLPLANE_ID": f"gw-{i}", "HOST": "127.0.0.1",
                    "PORT": str(ports["replicas"][i])})
            engine = _kvx_engine(torch)   # the processes start meanwhile
            out = asyncio.run(_cp_serve(torch, engine, procs, ports))
            check(not engine.running, "controlplane: the engine's runner did not stop")
            del engine
            engine = _kvx_engine(torch, model=_kvx_f32_model(), dtype="float32")
            with _PlainWatch(torch) as plain:
                out["kill_f32"] = asyncio.run(_cp_kill(engine, procs, ports))
            check(not any(plain.counts.values()),
                  f"controlplane f32: a plain version ran: {plain.counts}")
            procs.check_alive("broker_e", "broker_d", "gw-0", "gw-1",
                              f"shard-{1 - out['kill_f32']['killed_shard']}")
            del engine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    print(json.dumps({"controlplane_ways": {w: {k: v[k] for k in ("ttft_ms_p50", "ttft_ms_p90",
                                                                  "output_tokens_per_s")}
                                            for w, v in out["ways"].items()},
                      "adoption_s": out["kill_f32"]["adoption_s"],
                      "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)
    return {"phase": "controlplane", "model": WORKER_MODEL, "dtype": "bfloat16", "card": card,
            "lease_ttl_ms": CP_TTL_MS, "renew_ms": CP_RENEW_MS, **out}


# ---------------------------------------------------------------------------
# embed: embeddings through the port's gateway
# ---------------------------------------------------------------------------

EMBED_MODELS = ("mxbai-embed-large", "llama3:8b")
EMBED_BATCHES = 4        # timed /api/embed requests of 32 texts, per model
EMBED_ALONE = 8          # texts of the first batch embedded one at a time too
# bf16: the largest L2 distance of a batched unit vector from its text's
# vector embedded alone (the bf16 attention tolerance)
EMBED_BF16_L2 = 3e-2
EMBED_CUT_LAYERS = 2


def _embed_texts(rng) -> list[str]:
    """32 texts of mixed lengths up to 512 tokens (byte tokenizer: a text of
    n bytes is n + 1 tokens): 20 of 256-511 bytes, one batch of 32 rows in
    the longest bucket with 12 padding rows of length 1, and 12 of 0-255
    bytes for the shorter buckets."""
    return ([_prompt(rng, rng.randrange(256, 512)) for _ in range(20)]
            + [_prompt(rng, rng.randrange(0, 256)) for _ in range(12)])


async def _embed_serve(torch, engines) -> dict:
    """Per model, after a warm-up request: with the launch counters from 0,
    EMBED_BATCHES /api/embed requests of 32 texts through the gateway, one
    after another (ms per batch, texts/s); unit norms; the first batch's
    texts 16-23 embedded alone, each within EMBED_BF16_L2 of its batched
    vector; the launches held to the path (flash_prefill alone for a
    decoder model, nothing for the encoder, whose attention is plain
    torch as in the JAX package); no plain version of a kernel."""
    import asyncio
    import random

    import numpy as np

    from gridllm_torch.ops import cuda_kernels as ck

    rng = random.Random(SEED + 31)
    out = {}
    async with _GatewayStack(None, f"{WORKER_ID}-embed", models=engines) as st:
        for name, engine in engines.items():
            s, _, b = await st.call("POST", "/api/embed",
                                    {"model": name, "input": _embed_texts(rng)})
            check(s == 200 and len(b["embeddings"]) == 32, f"embed {name}: warm-up {s} {b}")
            batches = [_embed_texts(rng) for _ in range(EMBED_BATCHES)]
            ck.reset_launch_counts()
            walls, vecs = [], []
            with _PlainWatch(torch) as plain:
                for texts in batches:
                    t0 = time.perf_counter()
                    s, _, b = await st.call("POST", "/api/embed", {"model": name, "input": texts})
                    walls.append(time.perf_counter() - t0)
                    check(s == 200 and len(b["embeddings"]) == len(texts),
                          f"embed {name}: /api/embed {s} {str(b)[:300]}")
                    vecs.append(b["embeddings"])
                launches = {k: v for k, v in ck.launch_counts().items() if v}
            check(not any(plain.counts.values()), f"embed {name}: a plain version ran: "
                  f"{plain.counts}")
            if engine.embedding_only:
                check(not launches, f"embed {name}: kernels launched: {launches}")
            else:
                check(launches.get("flash_prefill", 0) > 0 and set(launches) == {"flash_prefill"},
                      f"embed {name}: launches {launches}")
            arr = np.asarray(vecs, np.float32)                # [batches, 32, E]
            norm_err = float(np.abs(np.linalg.norm(arr, axis=-1) - 1.0).max())
            check(norm_err <= 1e-3, f"embed {name}: a vector's norm is off 1 by {norm_err}")
            check(bool(np.isfinite(arr).all()), f"embed {name}: a vector is not finite")
            alone_texts = batches[0][16:16 + EMBED_ALONE]
            alone = np.asarray([(await asyncio.to_thread(engine.embed, [t]))[0]
                                for t in alone_texts], np.float32)
            l2 = float(np.linalg.norm(alone - arr[0, 16:16 + EMBED_ALONE], axis=-1).max())
            check(l2 <= EMBED_BF16_L2, f"embed {name}: batched against alone L2 {l2} > "
                  f"{EMBED_BF16_L2}")
            t0 = time.perf_counter()
            await asyncio.to_thread(engine.embed, batches[0])
            engine_ms = (time.perf_counter() - t0) * 1e3
            out[name] = {"dim": arr.shape[-1], "batches": len(batches),
                         "ms_per_batch_of_32": sum(walls) / len(walls) * 1e3,
                         "engine_ms_per_batch_of_32": engine_ms,
                         "texts_per_s": len(batches) * 32 / sum(walls),
                         "max_norm_err": norm_err, "batched_vs_alone_l2": l2,
                         "launches": launches}
    return out


def _embed_f32_cuts(torch) -> dict:
    """Float32 cuts at EMBED_CUT_LAYERS layers, full width: llama3:8b's
    embeddings through flash_prefill against the same engine with the plain
    attention (attention_prefill_ref), within F32_TOL; mxbai-embed-large's
    batched vectors against each text alone (its padding masked)."""
    import random

    import numpy as np

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.models import llama as llama_mod
    from gridllm_torch.ops.attention import attention_prefill_ref
    from gridllm_torch.ops.kernels import F32_TOL

    torch.backends.cuda.matmul.allow_tf32 = False
    texts = _embed_texts(random.Random(SEED + 32))
    out = {}
    engine = InferenceEngine(EngineConfig(model=_cut("llama3:8b", EMBED_CUT_LAYERS),
                                          dtype="float32"), device="cuda")
    with _PlainWatch(torch) as plain:
        got = np.asarray(engine.embed(texts))
    check(not any(plain.counts.values()), f"embed f32: a plain version ran: {plain.counts}")
    kernel = llama_mod.attention_prefill
    llama_mod.attention_prefill = attention_prefill_ref
    try:
        want = np.asarray(engine.embed(texts))
    finally:
        llama_mod.attention_prefill = kernel
    err = float(np.abs(got - want).max())
    check(err <= F32_TOL, f"embed f32 llama3:8b cut: kernel against plain {err} > {F32_TOL}")
    out["llama3:8b"] = {"max_abs_err_vs_plain": err}
    del engine
    engine = InferenceEngine(EngineConfig(model=_cut("mxbai-embed-large", EMBED_CUT_LAYERS),
                                          dtype="float32"), device="cuda")
    got = np.asarray(engine.embed(texts))
    alone = np.asarray([engine.embed([t])[0] for t in texts[16:16 + EMBED_ALONE]])
    err = float(np.abs(alone - got[16:16 + EMBED_ALONE]).max())
    check(err <= 1e-5, f"embed f32 mxbai cut: batched against alone {err}")
    out["mxbai-embed-large"] = {"max_abs_err_batched_vs_alone": err}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_embed(torch) -> dict:
    """Embeddings through the port's gateway (phase_embed): one port
    WorkerService serving mxbai-embed-large (bf16, 24 layers, E 1,024, cls
    pooling, an embedding-only engine) and llama3:8b (bf16, all 32 layers,
    its runner live, mean pooling over flash_prefill at B up to 32 with a
    length per row) behind a local-mode GatewayServer: /api/embed batches
    of 32 texts of mixed lengths up to 512 tokens (_embed_serve), then the
    float32 cuts (_embed_f32_cuts)."""
    import asyncio

    from gridllm_torch.engine import EngineConfig, InferenceEngine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    engines = {"mxbai-embed-large": InferenceEngine(EngineConfig(model="mxbai-embed-large"),
                                                    device="cuda"),
               "llama3:8b": InferenceEngine(EngineConfig(model="llama3:8b"), device="cuda")}
    check(engines["mxbai-embed-large"].embedding_only, "embed: mxbai is not embedding-only")
    out = {"models": asyncio.run(_embed_serve(torch, engines))}
    check(not engines["llama3:8b"].running, "embed: the llama3:8b runner did not stop")
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    out["f32_cuts"] = _embed_f32_cuts(torch)
    card = card_line()
    print(json.dumps({"embed": {m: {k: v[k] for k in ("texts_per_s", "ms_per_batch_of_32")}
                                for m, v in out["models"].items()},
                      "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)
    launches = {}
    for v in out["models"].values():
        for k, n in v["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return {"phase": "embed", "dtype": "bfloat16", "card": card, "launches": launches, **out}


# ---------------------------------------------------------------------------
# vision: llava:7b through the port's gateway
# ---------------------------------------------------------------------------

VISION_MODEL = "llava:7b"
# 512 KiB of pool a token at 32 KV heads: 320 pages of 64 are 20,480 tokens
# (10 GiB), five requests at llava's 4,096 each
VISION_ENGINE = dict(model=VISION_MODEL, page_size=64, num_pages=320, max_pages_per_slot=64)
VISION_TOKENS = 32
VISION_RUNS = 3          # solo runs of each kind, for TTFT
VISION_WAVES = 2         # waves of eight concurrent image streams
VISION_CUT_LAYERS = 2
VISION_PICTURE = (480, 640)


def _picture(seed: int):
    """A seeded 8-bit RGB picture of VISION_PICTURE: color gradients plus
    noise."""
    import numpy as np

    h, w = VISION_PICTURE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 255 / (w + h)], axis=-1)
    noise = np.random.default_rng(seed).normal(0, 24, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _png(arr) -> bytes:
    """[H, W, 3] uint8 → a PNG file written here with zlib and struct (no
    PIL): the rows take the five filters in turn (None, Sub, Up, Average,
    Paeth), so the port's decoder undoes each of them."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = arr.shape
    x = arr.reshape(h, w * 3).astype(np.int32)
    up = np.vstack([np.zeros((1, w * 3), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int32), x[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int32), up[:, :-3]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    kinds = np.arange(h) % 5
    pred = np.stack([np.zeros_like(x), left, up, (left + up) // 2, paeth])[kinds, np.arange(h)]
    rows = np.hstack([kinds[:, None], (x - pred) % 256]).astype(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


async def _vision_stream(http, base, path, body, n) -> tuple[float, str, dict]:
    """One streamed greedy /api/generate or /api/chat of VISION_MODEL."""
    return await _ndjson_stream(http, base, None, n, model=VISION_MODEL, path=path, body=body)


async def _vision_serve(torch, engine, images) -> dict:
    """After a one- and a two-image warm-up, with the launch counters from
    0: VISION_RUNS solo runs each of a one-image /api/generate (the bucket
    prefill), a text-only prompt of the same expanded length, and a
    two-image /api/generate (over the 1,024-token chunk: mixed steps whose
    chunk region splices each chunk's image rows), then VISION_WAVES waves
    of eight concurrent streams, /api/generate and /api/chat with images in
    a message, one and two images each; TTFT p50 per kind, TTFT p50 and
    tokens/s of the waves; every kernel of the ragged path launched, no
    plain version."""
    import asyncio
    import random

    from gridllm_torch.ops import cuda_kernels as ck

    rng = random.Random(SEED + 41)
    n_img = engine.cfg.vision_cfg.num_patches
    async with _GatewayStack(None, f"{WORKER_ID}-vision",
                             models={VISION_MODEL: engine}) as st:
        for imgs in (images[:1], images[:2]):
            s, _, b = await st.call("POST", "/api/generate", {
                "model": VISION_MODEL, "prompt": "warm up", "images": imgs, "stream": False,
                "options": {"temperature": 0, "num_predict": 4}})
            check(s == 200 and b.get("done"), f"vision: warm-up {s} {b}")
        ck.reset_launch_counts()
        ttft: dict[str, list] = {"one_image": [], "text_same_length": [], "two_images": []}
        with _PlainWatch(torch) as plain:
            for i in range(VISION_RUNS):
                text = "describe this picture"
                # a text prompt as long as the one-image request expanded
                same = (_prompt(rng, n_img + len(text)) + " " * (n_img + len(text)))
                counts = {}
                for kind, body in (
                        ("one_image", {"prompt": text, "images": images[i:i + 1]}),
                        ("text_same_length", {"prompt": same[:n_img + len(text)]}),
                        ("two_images", {"prompt": text, "images": images[i:i + 2]})):
                    t, _, last = await _vision_stream(st.http, st.base, "/api/generate", body,
                                                      VISION_TOKENS)
                    check(last["eval_count"] == VISION_TOKENS, f"vision {kind}: {last}")
                    counts[kind] = last["prompt_eval_count"]
                    ttft[kind].append(t * 1e3)
                check(counts["one_image"] == counts["text_same_length"] > n_img
                      and counts["two_images"] == counts["one_image"] + n_img,
                      f"vision: prompt token counts {counts}")
            wave = []
            for i in range(4):
                imgs = images[i % len(images):i % len(images) + 1 + i % 2]
                wave.append(("/api/generate", {"prompt": f"picture {i}", "images": imgs}))
                wave.append(("/api/chat", {"messages": [
                    {"role": "user", "content": f"what is in picture {i}?", "images": imgs}]}))
            runs = []
            for _ in range(VISION_WAVES):
                t0 = time.perf_counter()
                got = await asyncio.gather(*[_vision_stream(st.http, st.base, path, body,
                                                            VISION_TOKENS)
                                             for path, body in wave])
                wall = time.perf_counter() - t0
                check(all(g[2]["eval_count"] == VISION_TOKENS for g in got),
                      "vision: a wave stream short")
                runs.append((wall, [g[0] * 1e3 for g in got]))
                await _wait(lambda: not engine.active_requests and not engine.queued_requests,
                            "vision: the engine idle")
            launches = {k: v for k, v in ck.launch_counts().items() if v}
    check(not any(plain.counts.values()), f"vision: a plain version ran: {plain.counts}")
    for name in ("flash_prefill", "ragged_attention", "ragged_attention.chunk",
                 "ragged_attention.group", "paged_write_decode", "paged_write_chunk"):
        check(launches.get(name, 0) > 0, f"vision: {name} never launched: {launches}")
    tokens = len(wave) * VISION_TOKENS
    return {"ttft_ms_p50": {k: _pct(v, 0.5) for k, v in ttft.items()}, "ttft_ms": ttft,
            "waves": {"streams": len(wave), "waves": len(runs),
                      "output_tokens_per_s": tokens * len(runs) / sum(r[0] for r in runs),
                      "ttft_ms_p50": _pct([t for r in runs for t in r[1]], 0.5),
                      "wall_s": [r[0] for r in runs]},
            "launches": launches}


def _vision_encode_timing(torch, engine, images) -> dict:
    """The host preprocessing of one picture (PNG decode, bicubic resize,
    crop, normalize) and the tower + projector's device time
    (encode_images) for one and two images."""
    from gridllm_torch.engine.images import preprocess_images

    size = engine.cfg.vision_cfg.image_size
    t0 = time.perf_counter()
    px = preprocess_images(images[:2], size)
    host_ms = (time.perf_counter() - t0) * 1e3 / 2
    out = {"preprocess_host_ms_per_image": host_ms}
    for n in (1, 2):
        x = torch.from_numpy(px[:n]).to("cuda", engine.dtype)
        out[f"encode_images_ms_{n}"] = time_ms(torch, lambda: engine.model.encode_images(x),
                                               iters=10)
        out[f"encode_images_device_ms_{n}"] = device_ms(
            torch, lambda: engine.model.encode_images(x), iters=10)
    return out


def _vision_f32_cut(torch, images) -> dict:
    """llava:7b's text stack cut to VISION_CUT_LAYERS layers (the tower at
    its 24), float32: greedy streams of one image (bucket prefill) and two
    images (chunks with splice offsets, mixed steps) through the engine
    equal the cache-free forward over the spliced embeddings with the
    plain attention: every generated token is the reference's argmax, or
    within F32_TOL of it."""
    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine
    from gridllm_torch.engine.images import preprocess_images
    from gridllm_torch.models import llama as llama_mod
    from gridllm_torch.ops.attention import attention_prefill_ref
    from gridllm_torch.ops.kernels import F32_TOL

    torch.backends.cuda.matmul.allow_tf32 = False
    engine = InferenceEngine(EngineConfig(**dict(
        VISION_ENGINE, model=_cut(VISION_MODEL, VISION_CUT_LAYERS), num_pages=64,
        dtype="float32")), device="cuda")
    _printable_head(torch, engine)
    model, vc = engine.model, engine.cfg.vision_cfg
    out = {}
    for name, imgs in (("one_image", images[:1]), ("two_images", images[:2])):
        with _PlainWatch(torch) as plain:
            res = engine.generate(GenerationRequest(
                id=f"f32-{name}", prompt="what do you see?", images=imgs,
                options={"temperature": 0, "num_predict": 24, "repeat_penalty": 1.0}))
        check(not any(plain.counts.values()), f"vision f32: a plain version ran: {plain.counts}")
        check(res.done_reason in ("stop", "length") and res.token_ids,
              f"vision f32 {name}: {res.done_reason} {res.error}")
        ids = torch.tensor(res.context, dtype=torch.int32, device="cuda")
        px = torch.from_numpy(preprocess_images(imgs, vc.image_size)).to("cuda", torch.float32)
        flat = model.encode_images(px).reshape(-1, engine.cfg.hidden_size)
        kernel = llama_mod.attention_prefill
        llama_mod.attention_prefill = attention_prefill_ref
        try:
            ref = model.forward(ids[None], embeds=model.splice_embeds(ids, flat)[None])[0]
        finally:
            llama_mod.attention_prefill = kernel
        n_prompt = res.prompt_eval_count
        gaps = []
        for j, tok in enumerate(res.token_ids[:-1] if res.done_reason == "stop"
                                else res.token_ids):
            row = ref[n_prompt - 1 + j]
            gaps.append(float(row.max() - row[tok]))
        worst = max(gaps)
        check(worst <= F32_TOL, f"vision f32 {name}: a generated token is {worst} below the "
              "reference's argmax logit")
        out[name] = {"prompt_tokens": n_prompt, "tokens": len(res.token_ids),
                     "argmax_equal": sum(g == 0.0 for g in gaps), "max_gap": worst}
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_vision(torch) -> dict:
    """llava:7b bf16 through the port's gateway (phase_vision): the 32-layer
    multi-head text stack (32 KV heads at D = 128, G = 1) and the
    CLIP-L/336 tower (576 patches an image), the engine's defaults with a
    pool of VISION_ENGINE; images are PNGs this script writes (_png, no
    PIL) of seeded pictures, decoded by the port's own decoder (checked
    here bit for bit against the pixels written). _vision_serve, then
    _vision_encode_timing, then the float32 cut (_vision_f32_cut)."""
    import asyncio
    import base64

    import numpy as np

    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.engine.images import decode_png

    t_phase = time.perf_counter()
    pictures = [_picture(SEED + i) for i in range(4)]
    pngs = [_png(p) for p in pictures]
    for p, raw in zip(pictures, pngs):
        check(bool(np.array_equal(decode_png(raw), p)), "vision: the PNG decoder differs")
    images = [base64.b64encode(raw).decode() for raw in pngs]
    gc.collect()
    torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(**VISION_ENGINE), device="cuda")
    _printable_head(torch, engine)
    out = asyncio.run(_vision_serve(torch, engine, images))
    check(not engine.running, "vision: the engine's runner did not stop")
    out["encode"] = _vision_encode_timing(torch, engine, images)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out["f32_cut"] = _vision_f32_cut(torch, images)
    card = card_line()
    print(json.dumps({"vision": {"ttft_ms_p50": out["ttft_ms_p50"],
                                 "waves": {k: out["waves"][k] for k in ("ttft_ms_p50",
                                                                         "output_tokens_per_s")},
                                 "encode_images_device_ms_1":
                                     out["encode"]["encode_images_device_ms_1"]},
                      "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)
    return {"phase": "vision", "model": VISION_MODEL, "dtype": "bfloat16", "card": card,
            "picture": list(VISION_PICTURE), **out}


# ---------------------------------------------------------------------------
# tp: tensor parallelism over a two-rank worker group on the one card
# ---------------------------------------------------------------------------

TP_MODEL = "llama3:8b"
TP_WORLD = 2
TP_CTL = "chip_smoke:tp:ctl"          # bus channels of the members' launch counters
TP_COUNTS = "chip_smoke:tp:counts"
# the wave: (prompt bytes, tokens), eight at once, one past the 1,024-token chunk
TP_WAVE = ((300, 48), (450, 40), (200, 48), (600, 32), (1500, 32), (350, 40), (250, 48),
           (400, 32))
TP_F32_LAYERS = 2
TP_F32_TOKENS = 24
TP_MAIN_PATH = ("flash_prefill", "ragged_attention", "ragged_attention.chunk",
                "paged_write_decode", "paged_write_chunk")
# float32 chunks run on the CUDA cores
TP_CUT_PATH = tuple(k.replace(".chunk", ".chunk_cores") for k in TP_MAIN_PATH)
TP_GLOO_OPS = ("all_reduce", "all_gather_into_tensor")


def _tp_gloo_ops(torch, device: str = "cuda:0") -> dict:
    """Which collectives gloo runs on CUDA tensors (the ops
    parallel/collectives.py uses), in float32 and bfloat16, checked
    against their sums and concatenations."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    ops = {}
    for dt in (torch.float32, torch.bfloat16):
        for op in TP_GLOO_OPS:
            x = torch.full((4,), rank + 1.0, dtype=dt, device=device)
            try:
                if op == "all_reduce":
                    dist.all_reduce(x)
                    ok = x.tolist() == [world * (world + 1) / 2] * 4
                else:
                    y = torch.empty(4 * world, dtype=dt, device=device)
                    dist.all_gather_into_tensor(y, x)
                    ok = y.tolist() == [float(r + 1) for r in range(world) for _ in range(4)]
                ops[f"{op}.{str(dt).split('.')[-1]}"] = "ok" if ok else "wrong result"
            except Exception as e:  # noqa: BLE001 — reported, and checked by the caller
                ops[f"{op}.{str(dt).split('.')[-1]}"] = f"{type(e).__name__}: {e}"[:200]
    return ops


# the collectives of a llama3:8b rank under tp = 2: (name, kind, shape, dtype)
TP_GLOO_SHAPES = (("decode_all_reduce", "all_reduce", (S, 4096), "bfloat16"),
                  ("prefill_all_reduce", "all_reduce", (1024, 4096), "bfloat16"),
                  ("logits_gather", "all_gather", (S, 128256 // TP_WORLD), "float32"))


def _tp_gloo_ms(torch, device: str = "cuda:0", iters: int = 20) -> dict:
    """Host ms of one gloo collective on CUDA tensors at the shapes a
    llama3:8b rank sends (a decode step's all-reduce, a 1,024-token
    prefill's, a decode step's logits gather), two ranks in lockstep; a
    collective returns when its result is on the device."""
    from gridllm_torch.parallel import collectives

    mesh = _tp_mesh()
    out = {}
    for name, kind, shape, dt in TP_GLOO_SHAPES:
        x = torch.ones(shape, dtype=getattr(torch, dt), device=device)
        fn = (lambda: collectives.all_reduce_sum(x, mesh)) if kind == "all_reduce" else \
            (lambda: collectives.gather_last(x, mesh))
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        out[name] = {"shape": list(shape), "dtype": dt, "bytes": x.numel() * x.element_size(),
                     "ms": (time.perf_counter() - t0) * 1e3 / iters}
    collectives.reset_counts()
    return out


def _tp_mesh():
    from gridllm_torch.parallel import MeshConfig, build_mesh

    return build_mesh(MeshConfig(tp=TP_WORLD))


def _tp_cut_prompts() -> list[str]:
    import random

    rng = random.Random(SEED + 20)
    return [_prompt(rng, 300), _prompt(rng, 1500)]   # a bucket prefill; mixed steps


def _tp_cut_engine(model: str, mesh):
    from gridllm_torch.engine import EngineConfig, InferenceEngine

    return InferenceEngine(EngineConfig(
        model=model, dtype="float32", max_slots=4, page_size=PS, num_pages=256,
        max_pages_per_slot=64, mesh=mesh), device="cuda:0")


def _tp_cut_streams(engine) -> list[list[int]]:
    from gridllm_torch.engine import GenerationRequest

    return [engine.generate(GenerationRequest(
        id=f"cut{i}", prompt=p, options={"temperature": 0, "num_predict": TP_F32_TOKENS})
    ).token_ids for i, p in enumerate(_tp_cut_prompts())]


# the float32 cut modes of the tp phase beyond the llama3:8b default path:
# mode → (model, its engine settings). Each runs as a worker group does:
# rank 0 serves and hands its plan records to the group's TCP store before
# each dispatch, rank 1 replays them; this process serves them unmeshed
TP_CUT_DRAFT = "llama3.2:1b"
TP_CUT_MODES = {
    "gemma2": ("gemma2:9b", {}),
    "llava": ("llava:7b", {}),
    "int8": ("llama3:8b", {"quantize": "int8"}),
    "per_phase": ("llama3:8b", {"ragged_attention": False, "spec_decode": False}),
    "per_phase_spec": ("llama3:8b", {"ragged_attention": False}),
    "draft": ("llama3:8b", {"draft": TP_CUT_DRAFT}),
    "prefix": ("llama3:8b", {"prefix_cache": True}),
}
TP_CUT_EMBED = "mxbai-embed-large"    # full depth, float32, both ranks embedding
TP_EMBED_REL = 1e-5
TP_END = {"op": "end"}
TP_STATE = ("tokens", "active", "counts", "window", "wlen")


def _tp_mode_engine(mode: str, mesh):
    """The float32 cut engine of a tp cut mode (its draft model cut too)."""
    from gridllm_torch.engine import EngineConfig, InferenceEngine

    base, extra = TP_CUT_MODES[mode]
    extra = dict(extra)
    if "draft" in extra:
        extra["draft_model"] = _cut(extra.pop("draft"), TP_F32_LAYERS)
    return InferenceEngine(EngineConfig(
        model=_cut(base, TP_F32_LAYERS), dtype="float32", max_slots=4, page_size=PS,
        num_pages=256, max_pages_per_slot=64, mesh=mesh, **extra), device="cuda:0")


def _tp_mode_requests(mode: str) -> list[dict]:
    """A mode's greedy requests: the cut's two prompts (a bucket prefill,
    a chunked one); llava one picture; prefix a prompt past the chunk and
    the same prompt extended (its warm hit)."""
    import base64

    if mode == "llava":
        img = base64.b64encode(_png(_picture(SEED + 22))).decode()
        return [dict(prompt="what do you see?", images=[img])]
    prompts = _tp_cut_prompts()
    if mode == "prefix":
        prompts = [prompts[1], prompts[1] + " and then some more"]
    return [dict(prompt=p) for p in prompts]


def _tp_mode_results(engine, mode: str, sink=None) -> list[dict]:
    from gridllm_torch.engine import GenerationRequest

    engine.plan_sink = sink
    out = []
    for i, req in enumerate(_tp_mode_requests(mode)):
        res = engine.generate(GenerationRequest(
            id=f"{mode}{i}", options={"temperature": 0, "num_predict": TP_F32_TOKENS}, **req))
        check(res.done_reason in ("stop", "length"), f"tp {mode}: {res.error}")
        out.append({"tokens": list(res.token_ids), "cached": res.cached_tokens})
    return out


def _tp_state_digest(engine) -> dict:
    """sha256 of each device-state tensor every rank holds whole."""
    import hashlib

    tensors = {k: getattr(engine, k) for k in TP_STATE}
    tensors.update(lengths=engine.cache.lengths, page_table=engine.cache.page_table,
                   step=engine.sampling.step)
    return {k: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
            for k, t in tensors.items()}


def _tp_cut_modes(torch, rank: int, store) -> dict:
    """A rank's float32 cut modes (TP_CUT_MODES, then the embeddings):
    rank 0 serves each mode's requests with its plan going to `store`,
    rank 1 replays it; each reports what it dispatched and its launches."""
    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.parallel import MeshConfig, collectives

    out = {}
    for mode in TP_CUT_MODES:
        engine = _tp_mode_engine(mode, MeshConfig(tp=TP_WORLD))
        ck.reset_launch_counts()
        collectives.reset_counts()
        got = _group_lockstep(engine, rank, store, mode,
                              lambda sink, e=engine, m=mode: _tp_mode_results(e, m, sink))
        got.update(launches=ck.launch_counts(),
                   collectives=dict(collectives.CALLS),
                   drafter=getattr(engine._drafter, "kind", None),
                   heads=[engine.model.n_heads, engine.model.n_kv_heads])
        out[mode] = got
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(model=TP_CUT_EMBED, dtype="float32",
                                          mesh=MeshConfig(tp=TP_WORLD)), device="cuda:0")
    collectives.reset_counts()
    out["embed"] = {"vectors": engine.embed(_tp_embed_texts()),
                    "collectives": dict(collectives.CALLS)}
    del engine
    torch.cuda.empty_cache()
    return out


def _tp_embed_texts() -> list[str]:
    import random

    return _embed_texts(random.Random(SEED + 23))[14:22]   # 8 texts, two buckets


def _tp_child(torch, args: list[str]) -> dict:
    """A member of the tp phase's groups. `cut RANK PORT STORE_PORT`: a rank
    of the float32 cut's two-rank gloo group on cuda:0, reporting the gloo
    ops on CUDA tensors and its greedy streams (both ranks run the same
    requests), then the cut modes (_tp_cut_modes: rank 0 serves, rank 1
    replays its plan through the TCP store at STORE_PORT); `worker LABEL
    BUS_URL`: worker/main.py's `run` on gloo on cuda:0 (a group member
    where the environment says so, else a plain worker; SMOKE_TP_ENGINES
    holds per-model engine settings as JSON), beside a task that zeroes
    and reports its launch and collective counters on bus messages."""
    import asyncio
    import datetime
    import os

    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.parallel import GroupConfig, MeshConfig, collectives, distributed

    if args[0] == "ep":
        return _ep_cut_child(torch, int(args[1]), args[2], int(args[3]))
    if args[0] == "cut":
        rank, port, store_port = int(args[1]), args[2], int(args[3])
        group = GroupConfig(coordinator=f"127.0.0.1:{port}", num_processes=TP_WORLD,
                            process_id=rank)
        distributed.initialize_group(group, backend="gloo", device="cuda:0", timeout_s=300)
        store = torch.distributed.TCPStore("127.0.0.1", store_port, TP_WORLD, rank == 0,
                                           timeout=datetime.timedelta(seconds=300))
        ops = _tp_gloo_ops(torch)
        gloo_ms = _tp_gloo_ms(torch)
        engine = _tp_cut_engine(_cut(TP_MODEL, TP_F32_LAYERS), MeshConfig(tp=TP_WORLD))
        ck.reset_launch_counts()
        streams = _tp_cut_streams(engine)
        out = {"rank": rank, "gloo_cuda_ops": ops, "gloo_ms": gloo_ms, "streams": streams,
               "launches": ck.launch_counts(), "collectives": dict(collectives.CALLS),
               "heads": [engine.model.n_heads, engine.model.n_kv_heads]}
        del engine
        torch.cuda.empty_cache()
        out["modes"] = _tp_cut_modes(torch, rank, store)
        distributed.shutdown_group(group)
        return out

    label, url = args[1], args[2]
    from gridllm_torch.bus import create_bus
    from gridllm_torch.models import mixtral as mx
    from gridllm_torch.worker import main as wmain

    build, config_cls = wmain.build_engines, wmain.EngineConfig
    extras = json.loads(os.environ.get("SMOKE_TP_ENGINES", "{}"))
    for base_model, layers in json.loads(os.environ.get("SMOKE_CUTS", "[]")):
        _cut(base_model, layers)   # the cut models this member serves, registered

    def config_of(**kw):
        # each model's settings of this serve (int8, a draft model, its pool)
        return config_cls(**{**kw, **extras.get(kw["model"], {})})

    def printable_engines(config, device="cuda"):
        # streams that carry text, as the worker phase's (_printable_head)
        engines = build(config, device=device)
        for engine in engines.values():
            _printable_head(torch, engine)
        return engines

    wmain.EngineConfig = config_of
    wmain.build_engines = printable_engines

    async def control() -> None:
        bus = create_bus(url)
        await bus.connect()

        async def on_cmd(_ch: str, raw: str) -> None:
            if raw == "reset":
                ck.reset_launch_counts()
                collectives.reset_counts()
                for k in mx.MOE_FORMS:
                    mx.MOE_FORMS[k] = 0
            await bus.publish(TP_COUNTS, json.dumps({
                "member": label, "cmd": raw, "launches": ck.launch_counts(),
                "collectives": dict(collectives.CALLS), "moe_forms": dict(mx.MOE_FORMS),
                # since the process started: the weights' load included
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "allocated_gib": torch.cuda.memory_allocated() / 2**30}))

        await bus.subscribe(TP_CTL, on_cmd)
        await asyncio.Event().wait()

    async def main() -> None:
        ctl = asyncio.create_task(control())
        try:
            await wmain.run(backend="gloo", device="cuda:0")
        finally:
            ctl.cancel()

    asyncio.run(main())
    return {"member": label}


def _tp_spawn(log_name: str, args: list[str], env: dict | None = None):
    import os

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    log = open(out / f"tp_{log_name}.txt", "w")
    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--tp-child", *args],
                            cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})},
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def _tp_stop(procs, timeout_s: float = 60.0) -> list:
    """SIGTERM every process, then SIGKILL what is left; their exit codes."""
    import signal

    for proc, _ in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    codes = []
    for proc, log in procs:
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
        codes.append(proc.returncode)
    return codes


def _tp_nccl_world_one(torch) -> dict:
    """An NCCL group of world size 1 on cuda:0: it initializes and
    all-reduces a CUDA tensor (the only NCCL group one card allows: NCCL
    puts no two ranks of a group on one device)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda:0"))
    try:
        x = torch.arange(8, dtype=torch.bfloat16, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        ok = x.tolist() == [float(i) for i in range(8)]
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    check(ok and backend == "nccl", "tp: the NCCL world-size-1 all-reduce")
    return {"backend": backend, "all_reduce_ok": ok}


def _tp_unmeshed_modes(torch) -> dict:
    """Each cut mode and the embeddings served unmeshed in this process:
    the references of the ranks'."""
    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.ops import cuda_kernels as ck

    out = {}
    for mode in TP_CUT_MODES:
        engine = _tp_mode_engine(mode, None)
        ck.reset_launch_counts()
        out[mode] = {"results": _tp_mode_results(engine, mode), "launches": ck.launch_counts()}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(model=TP_CUT_EMBED, dtype="float32"), device="cuda:0")
    out["embed"] = {"vectors": engine.embed(_tp_embed_texts())}
    del engine
    torch.cuda.empty_cache()
    return out


# the kernels each cut mode must launch on both ranks (float32 chunks run
# on the CUDA cores; the draft model launches on the liaison alone)
TP_MODE_KERNELS = {
    "gemma2": TP_CUT_PATH, "int8": TP_CUT_PATH,
    # both prompts past the chunk: no bucket prefill
    "prefix": tuple(k for k in TP_CUT_PATH if k != "flash_prefill"),
    "llava": ("flash_prefill", "ragged_attention", "paged_write_decode", "paged_write_chunk"),
    "per_phase": ("flash_prefill", "paged_decode", "prefix_chunk.chunk_cores",
                  "paged_write_decode", "paged_write_chunk"),
    "per_phase_spec": ("flash_prefill", "prefix_chunk.slots", "prefix_chunk.chunk_cores",
                       "paged_write_decode", "paged_write_chunk"),
    "draft": ("flash_prefill", "ragged_attention.tree", "ragged_attention.chunk_cores",
              "paged_write_decode", "paged_write_chunk"),
}


def _tp_check_modes(ranks: list, want: dict) -> dict:
    """The cut modes' checks: rank 0's streams (and cached counts) equal the
    unmeshed engine's; rank 1 dispatched the same admits and holds the
    same replicated state; each mode's kernels launched on both ranks; the
    warm prefix hit replayed with cached > 0 on both; the draft model on
    the liaison alone, its trees replayed as verify_tree records; the
    embeddings within TP_EMBED_REL of the unmeshed engine's."""
    import numpy as np

    out = {}
    for mode in TP_CUT_MODES:
        lead, follow = (r["modes"][mode] for r in ranks)
        check(lead["results"] == want[mode]["results"],
              f"tp {mode}: the float32 tp = 2 streams differ from the unmeshed engine's: "
              f"{lead['results']} vs {want[mode]['results']}")
        check(follow["admits"] == lead["admits"], f"tp {mode}: the follower's admits differ")
        check(follow["state"] == lead["state"], f"tp {mode}: the follower's state differs: "
              f"{follow['state']} vs {lead['state']}")
        for r, got in enumerate((lead, follow)):
            missing = [k for k in TP_MODE_KERNELS[mode] if not got["launches"].get(k)]
            check(not missing, f"tp {mode}: rank {r} launched no {missing}")
        out[mode] = {"tokens": [len(x["tokens"]) for x in lead["results"]],
                     "streams_equal": True, "admits_cached": lead["admits"],
                     "heads_per_rank": lead["heads"],
                     "launches_per_rank": [{k: v for k, v in g["launches"].items() if v}
                                           for g in (lead, follow)],
                     "launches_unmeshed": {k: v for k, v in want[mode]["launches"].items()
                                           if v},
                     "collectives_per_rank": [g["collectives"] for g in (lead, follow)]}
    for r in ranks:
        check(r["modes"]["prefix"]["admits"][1] > 0, "tp prefix: no warm hit")
    lead, follow = (r["modes"]["draft"] for r in ranks)
    check(lead["drafter"] == "model" and follow["drafter"] != "model",
          f"tp draft: drafters {lead['drafter']}, {follow['drafter']}")
    check("verify_tree" in follow["ops"], f"tp draft: no verify_tree replayed: {follow['ops']}")
    ref = np.asarray(want["embed"]["vectors"])
    errs = [float(np.abs(np.asarray(r["modes"]["embed"]["vectors"]) - ref).max()) for r in ranks]
    check(max(errs) <= TP_EMBED_REL, f"tp embed: {errs} > {TP_EMBED_REL}")
    out["embed"] = {"model": TP_CUT_EMBED, "texts": len(ref), "max_abs_err_per_rank": errs,
                    "collectives_per_rank": [r["modes"]["embed"]["collectives"] for r in ranks]}
    return out


def _tp_f32_cut(torch) -> dict:
    """The float32 cut: two ranks (gloo, both on cuda:0) serve its greedy
    streams over tp = 2 while this process serves them unmeshed; the
    streams must be equal token for token. Then the cut modes, each held
    against this process's unmeshed engine (_tp_check_modes)."""
    from gridllm_torch.ops import cuda_kernels as ck

    port, store_port = _free_port(), _free_port()
    out = REPO / "chiprun_out"
    procs = [_tp_spawn(f"cut_rank{r}", ["cut", str(r), str(port), str(store_port)])
             for r in range(TP_WORLD)]
    try:
        ck.reset_launch_counts()
        engine = _tp_cut_engine(_cut(TP_MODEL, TP_F32_LAYERS), None)
        want = _tp_cut_streams(engine)
        unmeshed_launches = ck.launch_counts()
        del engine
        torch.cuda.empty_cache()
        want_modes = _tp_unmeshed_modes(torch)
        for proc, _ in procs:
            proc.wait(timeout=900)
    finally:
        codes = _tp_stop(procs)
    check(codes == [0] * TP_WORLD, f"tp: a cut rank failed ({codes}): see chiprun_out/tp_cut_*")
    ranks = []
    for r in range(TP_WORLD):
        lines = (out / f"tp_cut_rank{r}.txt").read_text().splitlines()
        ranks.append(json.loads(next(ln for ln in reversed(lines) if ln.startswith('{"ok"'))))
    for r in ranks:
        bad = {k: v for k, v in r["gloo_cuda_ops"].items() if v != "ok"}
        check(not bad, f"tp: gloo ops on CUDA tensors failed: {bad}")
        check(r["streams"] == want, f"tp: rank {r['rank']}'s float32 stream differs from "
              f"the unmeshed engine's: {r['streams']} vs {want}")
        check(all(r["launches"][k] > 0 for k in TP_CUT_PATH),
              f"tp: a cut rank skipped a kernel: {r['launches']}")
    check(ranks[0]["launches"] == ranks[1]["launches"], "tp: the cut ranks' launches differ")
    return {"layers": TP_F32_LAYERS, "tokens": [len(x) for x in want], "streams_equal": True,
            "gloo_cuda_ops": ranks[0]["gloo_cuda_ops"], "gloo_ms": ranks[0]["gloo_ms"],
            "heads_per_rank": ranks[0]["heads"],
            "launches_per_rank": {k: ranks[0]["launches"][k] for k in TP_CUT_PATH},
            "launches_unmeshed": {k: unmeshed_launches[k] for k in TP_CUT_PATH},
            "collectives_per_rank": ranks[0]["collectives"],
            "modes": _tp_check_modes(ranks, want_modes)}


def _tp_wave_jobs(rng) -> list[dict]:
    """The llama3:8b wave of the first serve: eight jobs at once."""
    return [{"model": TP_MODEL, "prompt": _prompt(rng, b), "tokens": n} for b, n in TP_WAVE]


async def _tp_way(name: str, bus, registry, scheduler, counts: list, env_of, jobs_of,
                  main_path=TP_MAIN_PATH, same_launches: bool = True) -> dict:
    """One way of serving a wave (a two-rank group, or one unmeshed
    worker): its processes start and register, each generation model takes
    a warm-up job, then the wave's jobs (`jobs_of(rng)`: generations with
    their model, prompt, tokens and images, or embedding jobs of texts) run
    at once with every member's counters from 0; per model TTFT p50 and
    output tokens/s as the scheduler's client sees them. Every member must
    launch each kernel of `main_path`, the same counts on each member
    unless `same_launches` is off (a draft model drafts on the liaison
    alone)."""
    import asyncio
    import random

    from gridllm_torch.utils.types import InferenceRequest

    members = env_of()
    procs = [_tp_spawn(f"{name}_{label}", ["worker", label, members[label]["url"]],
                       env=members[label]["env"]) for label in members]
    wid = next(iter(members.values()))["env"]["WORKER_ID"]
    t_start = time.perf_counter()

    def req(rid, job):
        if "texts" in job:
            return InferenceRequest(id=f"{name}-{rid}", model=job["model"], input=job["texts"],
                                    metadata={"requestType": "embedding"})
        return InferenceRequest(id=f"{name}-{rid}", model=job["model"], prompt=job["prompt"],
                                images=job.get("images"), stream=True,
                                options={"temperature": 0, "num_predict": job["tokens"]},
                                metadata={"requestType": "inference"})

    async def run(r):
        if r.metadata["requestType"] == "embedding":
            t0 = time.perf_counter()
            res = await scheduler.submit_and_wait(r, timeout_ms=600_000)
            return res, None, time.perf_counter() - t0
        chunks, first = [], []
        t0 = time.perf_counter()

        async def on_chunk(c):
            if not first:
                first.append(time.perf_counter() - t0)
            chunks.append(c.response or "")

        res = await scheduler.submit_streaming_job(r, on_chunk, timeout_ms=600_000)
        return res, "".join(chunks), (first[0] if first else None)

    async def tally(cmd: str) -> dict:
        counts.clear()
        await bus.publish(TP_CTL, cmd)
        await _wait(lambda: len({c["member"] for c in counts if c["cmd"] == cmd}) == len(members),
                    f"tp: {name} counters ({cmd})", 60)
        return {c["member"]: c for c in counts if c["cmd"] == cmd}

    rng = random.Random(SEED + 21)
    jobs = jobs_of(rng)
    try:
        def alive():
            for proc, _ in procs:
                check(proc.poll() is None, f"tp: a {name} member exited ({proc.returncode}): "
                      f"see chiprun_out/tp_{name}_*")
            return registry.get_worker(wid) is not None

        await _wait(alive, f"tp: {name} registered", 600)
        ready_s = time.perf_counter() - t_start
        check(list(await bus.hgetall("workers")) == [wid], f"tp: {name} is not one worker")
        warm = {j["model"]: j for j in jobs if "texts" not in j}
        done = await asyncio.gather(*(run(req(f"warm-{i}", dict(j, tokens=8)))
                                      for i, j in enumerate(warm.values())))
        for res, _, _ in done:   # warm-up, not measured
            check(res.success, f"tp: {name} warm-up: {res.error}")
        await tally("reset")
        wave = [req(f"w{i}", j) for i, j in enumerate(jobs)]
        t0 = time.perf_counter()
        done = await asyncio.gather(*(run(r) for r in wave))
        wall = time.perf_counter() - t0
        read = await tally("read")
    finally:
        # off the event loop: the members drain through the broker it serves
        codes = await asyncio.to_thread(_tp_stop, procs)
    per_model: dict = {}
    texts = []
    for r, job, (res, text, first) in zip(wave, jobs, done):
        check(res.success, f"tp: {name} job {r.id}: {res.error}")
        check(res.workerId == wid, f"tp: {name} job {r.id} served by {res.workerId}")
        m = per_model.setdefault(job["model"], {"jobs": 0, "output_tokens": 0, "ttft_ms": []})
        m["jobs"] += 1
        if "texts" in job:
            vecs = res.response.embeddings or []
            check(len(vecs) == len(job["texts"]), f"tp: {name} job {r.id}: {len(vecs)} vectors")
            m["ms"] = first * 1e3
            texts.append(json.dumps([round(x, 3) for x in vecs[0][:8]]))
            continue
        n, ev = job["tokens"], res.response.eval_count
        check(ev == n or (res.response.done_reason == "stop" and ev < n),
              f"tp: {name} job {r.id}: {ev} of {n} tokens")
        check(text == _final_text(res), f"tp: {name} job {r.id}: stream != final text")
        check(first is not None, f"tp: {name} job {r.id} streamed no chunk")
        m["output_tokens"] += ev
        m["ttft_ms"].append(first * 1e3)
        texts.append(text)
    for m in per_model.values():
        if m["ttft_ms"]:
            m["ttft_ms_p50"] = statistics.median(m["ttft_ms"])
            m["output_tokens_per_s"] = m["output_tokens"] / wall
    launches = {m: {k: v for k, v in c["launches"].items() if v} for m, c in read.items()}
    for m, c in launches.items():
        missing = [k for k in main_path if not c.get(k)]
        check(not missing, f"tp: {name} {m} launched no {missing}: {c}")
    if same_launches:
        check(len({json.dumps(c, sort_keys=True) for c in launches.values()}) == 1,
              f"tp: {name} members launched differently: {launches}")
    out = {"members": len(procs), "ready_s": ready_s, "wall_s": wall, "models": per_model,
           "launches": launches, "collectives": {m: c["collectives"] for m, c in read.items()},
           "moe_forms": {m: {k: v for k, v in c["moe_forms"].items() if v}
                         for m, c in read.items()},
           "peak_gib": {m: c["peak_gib"] for m, c in read.items()},
           "allocated_gib": {m: c["allocated_gib"] for m, c in read.items()},
           "exit_codes": codes, "texts": texts}
    if len(per_model) == 1:   # the first serve's keys, as they were
        (m,) = per_model.values()
        out.update(ttft_ms_p50=m["ttft_ms_p50"], ttft_ms=m["ttft_ms"],
                   output_tokens=m["output_tokens"],
                   output_tokens_per_s=m["output_tokens_per_s"])
    return out


# the bf16 serves of the modes, each a two-rank group of worker/main.py
# processes and then one unmeshed worker with the same models: (models,
# per-model engine settings, the wave's jobs, the kernels every member
# launches, whether the members launch alike)
TP_DRAFT = "llama3.2:1b"
TP_SERVE_PAGES = 256          # each engine's pool: the wave needs < 120 pages a model
TP_MODE_TOKENS = 32


def _tp_jobs_tree(rng) -> list[dict]:
    texts = _tp_embed_texts()
    return ([{"model": TP_MODEL, "prompt": _prompt(rng, b), "tokens": TP_MODE_TOKENS}
             for b in (300, 450, 1500)]
            + [{"model": "mxbai-embed-large", "texts": texts}])


def _tp_jobs_families(rng) -> list[dict]:
    import base64

    img = base64.b64encode(_png(_picture(SEED + 24))).decode()
    return ([{"model": m, "prompt": _prompt(rng, b), "tokens": TP_MODE_TOKENS}
             for m in ("gemma2:9b", TP_MODEL) for b in (300, 1500)]
            + [{"model": "llava:7b", "prompt": "what do you see?", "images": [img],
                "tokens": TP_MODE_TOKENS},
               {"model": "llava:7b", "prompt": _prompt(rng, 400), "tokens": TP_MODE_TOKENS}])


TP_SERVES = {
    # llama3:8b with llama3.2:1b's trees, beside mxbai-embed-large's jobs
    "tree": ((TP_MODEL, "mxbai-embed-large"),
             {TP_MODEL: {"draft_model": TP_DRAFT, "num_pages": TP_SERVE_PAGES}},
             _tp_jobs_tree,
             ("flash_prefill", "ragged_attention", "ragged_attention.tree",
              "paged_write_decode", "paged_write_chunk"), False),
    # gemma2:9b, llama3:8b with int8 weights, llava:7b with a picture
    "families": (("gemma2:9b", TP_MODEL, "llava:7b"),
                 {"gemma2:9b": {"num_pages": TP_SERVE_PAGES},
                  TP_MODEL: {"quantize": "int8", "num_pages": TP_SERVE_PAGES},
                  "llava:7b": {"num_pages": TP_SERVE_PAGES}},
                 _tp_jobs_families, TP_MAIN_PATH, True),
}


async def _group_serves(ways: list, mesh_shape: str, world: int, tag: str,
                        cuts: tuple = ()) -> dict:
    """Each way of `ways` ((key, models, per-model engine settings, the
    wave's jobs, the kernels every member launches, whether the members
    launch alike)) served bf16 by a group of `world` worker/main.py
    processes over GRIDLLM_MESH_SHAPE=`mesh_shape` (gloo, every rank on
    cuda:0) as one logical worker behind the port's scheduler on the
    port's broker, then, once the group is torn down, by one unmeshed
    worker process on the same broker with the same models and jobs.
    `cuts` ((base, layers) pairs) are registered in every member."""
    from gridllm_torch.bus import create_bus
    from gridllm_torch.bus.broker import GridBusBroker
    from gridllm_torch.scheduler import JobScheduler, WorkerRegistry
    from gridllm_torch.utils.config import SchedulerConfig

    broker = GridBusBroker()
    await broker.start(port=0)
    url = f"resp://127.0.0.1:{broker.port}"
    bus = create_bus(url)
    await bus.connect()
    registry = WorkerRegistry(bus, SchedulerConfig())
    scheduler = JobScheduler(bus, registry, SchedulerConfig())
    await registry.initialize()
    await scheduler.initialize()
    counts: list = []

    async def on_counts(_ch, raw):
        counts.append(json.loads(raw))

    sub = await bus.subscribe(TP_COUNTS, on_counts)

    def base(models, engines):
        return {"GRIDLLM_BUS_URL": url, "GRIDLLM_MODELS": ",".join(models),
                "GRIDLLM_KV_PAGE_SIZE": str(PS), "GRIDLLM_MAX_BATCH_SLOTS": str(S),
                "HEARTBEAT_INTERVAL": "1000", "SMOKE_TP_ENGINES": json.dumps(engines),
                "SMOKE_CUTS": json.dumps(cuts)}

    def group_env(wid, env):
        def members():
            coord = f"127.0.0.1:{_free_port()}"
            return {f"rank{r}": {"url": url, "env": {
                **env, "WORKER_ID": wid, "GRIDLLM_MESH_SHAPE": mesh_shape,
                "GRIDLLM_NUM_PROCS": str(world), "GRIDLLM_PROC_ID": str(r),
                "GRIDLLM_COORD_ADDR": coord, "WORKER_PORT": str(_free_port())}}
                for r in range(world)}
        return members

    def plain_env(wid, env):
        return lambda: {"plain": {"url": url, "env": {**env, "WORKER_ID": wid,
                                                      "WORKER_PORT": str(_free_port())}}}

    out = {}
    try:
        for key, models, engines, jobs, path, same in ways:
            env = base(models, engines)
            prefix = "" if key == "llama" else f"{key}_"
            gid, pid = f"{tag}-{prefix}group", f"{tag}-{prefix}plain"
            group = await _tp_way(f"{prefix}group", bus, registry, scheduler, counts,
                                  group_env(gid, env), jobs, path, same)
            await _wait(lambda: registry.get_worker(gid) is None, f"{tag}: the group left", 120)
            plain = await _tp_way(f"{prefix}plain", bus, registry, scheduler, counts,
                                  plain_env(pid, env), jobs, path)
            await _wait(lambda: registry.get_worker(pid) is None, f"{tag}: the worker left", 120)
            g_texts, p_texts = group.pop("texts"), plain.pop("texts")
            same_n = sum(a == b for a, b in zip(g_texts, p_texts))
            out[key] = {
                "group": group, "unmeshed": plain,
                # bf16 sums run in another order: a reading, not a check
                "bf16_streams_equal_to_unmeshed": f"{same_n}/{len(g_texts)}"}
    finally:
        await sub.unsubscribe()
        await scheduler.shutdown()
        await registry.shutdown()
        await bus.disconnect()
        await broker.stop()
    return out


async def _tp_serve() -> dict:
    """bf16 at full width and depth: llama3:8b's wave, then each of
    TP_SERVES, served by a two-rank tp group and by one unmeshed worker
    (_group_serves)."""
    ways = [("llama", (TP_MODEL,), {}, _tp_wave_jobs, TP_MAIN_PATH, True)]
    ways += [(k, *v) for k, v in TP_SERVES.items()]
    out = await _group_serves(ways, f"tp:{TP_WORLD}", TP_WORLD, "tp")
    first = out.pop("llama")
    first["modes"] = out
    first["note"] = ("two ranks on one card over gloo: every all-reduce is a round trip "
                     "through host memory; a correctness run, not a TP speed")
    return first


def phase_tp(torch) -> dict:
    """Tensor parallelism: an NCCL group of world size 1; the float32 cuts
    whose tp = 2 streams equal the unmeshed engine's (and the gloo ops on
    CUDA tensors), for llama3:8b and then every family and mode a group
    serves; bf16 serves through the port's bus worker by two-rank groups,
    each beside an unmeshed worker."""
    import asyncio

    t0 = time.perf_counter()
    out = {"phase": "tp", "card": card_line(), "nccl_world_1": _tp_nccl_world_one(torch)}
    out["f32_cut"] = _tp_f32_cut(torch)
    out["serve"] = asyncio.run(_tp_serve())
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# ep: mixtral's experts over ep and ep × tp, and dp replicas (phase_ep)
# ---------------------------------------------------------------------------

EP_WORLD = 4
EP_F32_LAYERS = 2
# the float32 cuts of one four-rank world, each mesh built in turn: name →
# (base model, mesh). dp × ep holds two ep = 2 pairs, each rank the share
# of a two-rank ep group
EP_CUTS = {
    "mixtral_ep_tp": (MIXTRAL_MODEL, dict(dp=1, ep=2, tp=2)),
    "mixtral_dp_ep": (MIXTRAL_MODEL, dict(dp=2, ep=2, tp=1)),
    "llama_dp_tp": (TP_MODEL, dict(dp=2, ep=1, tp=2)),
}
# the heads a rank holds (H, KVH): tp splits them, ep and dp do not
EP_CUT_HEADS = {"mixtral_ep_tp": [H // 2, KVH // 2], "mixtral_dp_ep": [H, KVH],
                "llama_dp_tp": [H // 2, KVH // 2]}
EP_WORLD_BF16 = 2     # the bf16 serve's ep = 2 group


def _ep_cut_engine(base: str, mesh):
    """A float32 cut with speculation off, so its decode steps take the
    (meshed) dense MoE form and its prefills and mixed steps the ragged."""
    from gridllm_torch.engine import EngineConfig, InferenceEngine

    return InferenceEngine(EngineConfig(
        model=_cut(base, EP_F32_LAYERS), dtype="float32", max_slots=4, page_size=PS,
        num_pages=256, max_pages_per_slot=64, spec_decode=False, mesh=mesh), device="cuda:0")


def _group_lockstep(engine, rank: int, store, key: str, serve) -> dict:
    """Generation as a worker group runs it: rank 0 serves (`serve(sink)`)
    and hands each plan record to the group's TCP store before its
    dispatch, the other ranks replay them in order. What the rank
    dispatched, its results (rank 0) and its replicated state."""
    got: dict = {"admits": [], "ops": []}

    def note(rec):
        got["ops"].append(rec["op"])
        if rec["op"] == "admit":
            got["admits"].append(int(rec["cached"]))

    if rank == 0:
        seq = iter(range(1, 1 << 30))

        def sink(rec):
            note(rec)
            store.set(f"{key}/{next(seq)}", json.dumps(rec))

        got["results"] = serve(sink)
        sink(TP_END)
    else:
        for i in range(1, 1 << 30):
            rec = json.loads(store.get(f"{key}/{i}"))
            if rec == TP_END:
                break
            note(rec)
            engine.apply_plan_op(rec)
    got["ops"] = sorted(set(got["ops"]) - {"end"})
    got["state"] = _tp_state_digest(engine)
    return got


def _ep_cut_child(torch, rank: int, port: str, store_port: int) -> dict:
    """A rank of the ep phase's four-rank gloo world on cuda:0: each cut of
    EP_CUTS under its mesh, rank 0 serving the cut's two greedy prompts,
    the others replaying its plan; per cut the rank's launches,
    collectives, MoE calls by form, heads, expert range and memory."""
    import datetime

    import torch.distributed as dist

    from gridllm_torch.models import mixtral as mx
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.quant import params_nbytes
    from gridllm_torch.parallel import GroupConfig, MeshConfig, collectives, distributed

    group = GroupConfig(coordinator=f"127.0.0.1:{port}", num_processes=EP_WORLD,
                        process_id=rank)
    distributed.initialize_group(group, backend="gloo", device="cuda:0", timeout_s=300)
    store = torch.distributed.TCPStore("127.0.0.1", store_port, EP_WORLD, rank == 0,
                                       timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank, "cuts": {}}
    for name, (base, shape) in EP_CUTS.items():
        torch.cuda.reset_peak_memory_stats()
        engine = _ep_cut_engine(base, MeshConfig(**shape))
        ck.reset_launch_counts()
        collectives.reset_counts()
        before = dict(mx.MOE_FORMS)
        got = _group_lockstep(engine, rank, store, name,
                              lambda sink, e=engine, n=name: _tp_mode_results(e, n, sink))
        model = engine.model
        got.update(launches=ck.launch_counts(), collectives=dict(collectives.CALLS),
                   moe_forms={k: v - before[k] for k, v in mx.MOE_FORMS.items()},
                   heads=[model.n_heads, model.n_kv_heads],
                   experts=model._expert_range(),
                   coords=dict(engine.mesh.coords),
                   weights_gib=params_nbytes(model.params_tree()) / 2**30,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        out["cuts"][name] = got
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    # rank 0 holds the store: it leaves once every rank has read its last record
    dist.barrier()
    distributed.shutdown_group(group)
    return out


def _ep_f32_cuts(torch) -> dict:
    """The float32 cuts: four ranks (gloo, all on cuda:0) serve each cut of
    EP_CUTS while this process serves it unmeshed; rank 0's streams must
    equal the unmeshed engine's, every follower hold the liaison's state,
    every rank launch the cut's kernels, and every rank of a mixtral cut
    take both meshed MoE forms with one all-reduce per meshed MoE call."""
    from gridllm_torch.models import mixtral as mx
    from gridllm_torch.ops import cuda_kernels as ck

    port, store_port = _free_port(), _free_port()
    log_dir = REPO / "chiprun_out"
    procs = [_tp_spawn(f"ep_cut_rank{r}", ["ep", str(r), str(port), str(store_port)])
             for r in range(EP_WORLD)]
    try:
        want = {}
        for name, (base, _) in EP_CUTS.items():
            engine = _ep_cut_engine(base, None)
            ck.reset_launch_counts()
            before = dict(mx.MOE_FORMS)
            want[name] = {"results": _tp_mode_results(engine, name),
                          "launches": ck.launch_counts(),
                          "moe_forms": {k: v - before[k] for k, v in mx.MOE_FORMS.items()}}
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        for proc, _ in procs:
            proc.wait(timeout=900)
    finally:
        codes = _tp_stop(procs)
    check(codes == [0] * EP_WORLD, f"ep: a cut rank failed ({codes}): see chiprun_out/tp_ep_cut_*")
    ranks = []
    for r in range(EP_WORLD):
        lines = (log_dir / f"tp_ep_cut_rank{r}.txt").read_text().splitlines()
        ranks.append(json.loads(next(ln for ln in reversed(lines) if ln.startswith('{"ok"'))))
    out = {}
    for name in EP_CUTS:
        per = [r["cuts"][name] for r in ranks]
        lead = per[0]
        check(lead["results"] == want[name]["results"],
              f"ep {name}: the float32 streams differ from the unmeshed engine's: "
              f"{lead['results']} vs {want[name]['results']}")
        for r, got in enumerate(per):
            check(got["admits"] == lead["admits"], f"ep {name}: rank {r}'s admits differ")
            check(got["state"] == lead["state"], f"ep {name}: rank {r}'s state differs: "
                  f"{got['state']} vs {lead['state']}")
            missing = [k for k in TP_CUT_PATH if not got["launches"].get(k)]
            check(not missing, f"ep {name}: rank {r} launched no {missing}")
            check(got["heads"] == EP_CUT_HEADS[name], f"ep {name}: rank {r} heads {got['heads']}")
            forms, calls = got["moe_forms"], got["collectives"]
            meshed = forms["dense_ep"] + forms["ragged_ep"]
            check(calls["all_reduce.moe"] == meshed,
                  f"ep {name}: rank {r} made {calls['all_reduce.moe']} MoE sums for {meshed} calls")
            if name.startswith("mixtral"):
                check(forms["dense_ep"] > 0 and forms["ragged_ep"] > 0,
                      f"ep {name}: rank {r} took the MoE forms {forms}")
        out[name] = {
            "mesh": EP_CUTS[name][1], "layers": EP_F32_LAYERS, "streams_equal": True,
            "tokens": [len(x["tokens"]) for x in lead["results"]],
            "heads_per_rank": lead["heads"],
            "experts_per_rank": [g["experts"] for g in per],
            "moe_forms_per_rank": [{k: v for k, v in g["moe_forms"].items() if v} for g in per],
            "moe_forms_unmeshed": {k: v for k, v in want[name]["moe_forms"].items() if v},
            "collectives_per_rank": [g["collectives"] for g in per],
            "launches_per_rank": [{k: v for k, v in g["launches"].items() if v} for g in per],
            "launches_unmeshed": {k: v for k, v in want[name]["launches"].items() if v},
            "weights_gib_per_rank": [g["weights_gib"] for g in per],
            "peak_gib_per_rank": [g["peak_gib"] for g in per]}
    return out


def _ep_wave_jobs(rng) -> list[dict]:
    """The tp phase's wave of eight jobs, on the MIXTRAL_LAYERS cut."""
    model = _cut(MIXTRAL_MODEL, MIXTRAL_LAYERS)
    return [{"model": model, "prompt": _prompt(rng, b), "tokens": n} for b, n in TP_WAVE]


async def _ep_serve() -> dict:
    """mixtral:8x7b bf16 at full width cut to MIXTRAL_LAYERS layers, the
    engine's defaults: the wave served by an ep = 2 group (each rank half
    the experts, attention whole) through the port's bus worker, then by
    one unmeshed worker once the group is gone (both at once exceed the
    card)."""
    model = _cut(MIXTRAL_MODEL, MIXTRAL_LAYERS)
    ways = [("mixtral", (model,), {model: {"num_pages": TP_SERVE_PAGES}}, _ep_wave_jobs,
             TP_MAIN_PATH, True)]
    out = (await _group_serves(ways, f"ep:{EP_WORLD_BF16}", EP_WORLD_BF16, "ep",
                               cuts=((MIXTRAL_MODEL, MIXTRAL_LAYERS),)))["mixtral"]
    for member, forms in out["group"]["moe_forms"].items():
        check(forms.get("ragged_ep", 0) > 0 and not forms.get("ragged"),
              f"ep serve: {member} took the MoE forms {forms}")
    out["note"] = ("two ranks on one card over gloo: each MoE all-reduce is a round trip "
                   "through host memory; a correctness run, not an EP speed")
    return out


def phase_ep(torch) -> dict:
    """Expert parallelism and dp replicas: the float32 cuts of one four-rank
    world (mixtral:8x7b under ep × tp and dp × ep, llama3:8b under dp × tp)
    against unmeshed engines, then mixtral:8x7b bf16 at MIXTRAL_LAYERS
    layers served by an ep = 2 group beside an unmeshed worker."""
    import asyncio

    t0 = time.perf_counter()
    out = {"phase": "ep", "card": card_line(), "f32_cuts": _ep_f32_cuts(torch)}
    out["serve"] = asyncio.run(_ep_serve())
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


TURN_PARTS = ("kernels", "steps", "int8")


def _turn_child(torch, parts: str) -> dict:
    """One turn of --turns, run in the tree under test (its package first
    on sys.path, its own build/): `kernels`, this file's
    _per_phase_timing through that tree's wrappers; `steps`, that tree's
    tools.profile_step.profile_steps on a llama3:8b engine (spec off);
    `int8`, this file's _int8_timing through that tree's wrappers and that
    tree's tools.profile_step.profile_int8 on a llama3:8b kv_int8 engine
    (spec off)."""
    from gridllm_torch.ops import _build

    report = _build.build_all()
    res = {"tree": str(Path.cwd()), "build_s": {k: r["seconds"] for k, r in report.items()}}
    for part in parts.split(","):
        check(part in TURN_PARTS, f"turns: unknown part {part!r}")
        if part == "kernels":
            res["kernels"] = _per_phase_timing(torch, Inputs(torch, SEED + 1))
            continue
        from gridllm_torch.engine import EngineConfig, InferenceEngine
        from gridllm_torch.tools import profile_step

        int8 = part == "int8"
        if int8:
            res["int8_kernels"] = _int8_timing(torch, Inputs(torch, SEED + 7))
        engine = InferenceEngine(EngineConfig(model="llama3:8b", spec_decode=False,
                                              kv_int8=int8), device="cuda")
        res[part] = (profile_step.profile_int8 if int8 else profile_step.profile_steps)(engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _turns(tree: Path, parts: str) -> dict:
    """`parts` (TURN_PARTS) of another checkout of the port (`tree`) and of
    this one, in turns tree, this, this, tree, each turn a process of its
    own on the same card; each turn's output in chiprun_out/turn_<i>.txt."""
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    turns = []
    for i, t in enumerate((tree, REPO, REPO, tree)):
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--turn-child", parts],
                              cwd=t, capture_output=True, text=True, timeout=1500)
        (out / f"turn_{i}.txt").write_text(proc.stdout + proc.stderr)
        check(proc.returncode == 0, f"turn {i} in {t} failed: {proc.stderr[-3000:]}")
        turns.append({"turn": i, "which": "other" if t == tree else "this",
                      **json.loads(proc.stdout.strip().splitlines()[-1])})
    return {"phase": "turns", "card": card_line(), "turns": turns}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--turns", metavar="TREE",
                    help="instead of the phases: time TREE (another checkout of the port) "
                         "and this tree in turns (TREE, this, this, TREE); see --turn-parts")
    ap.add_argument("--turn-parts", default="kernels",
                    help="comma-separated subset of " + ",".join(TURN_PARTS))
    ap.add_argument("--profiler-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint-child", help=argparse.SUPPRESS)
    ap.add_argument("--prewarm", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--turn-child", help=argparse.SUPPRESS)
    ap.add_argument("--tp-child", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.turn_child:   # the tree under test is the working directory
        sys.path.insert(0, str(Path.cwd()))
        emit({"ok": True, **_turn_child(torch, args.turn_child)})
        return 0
    sys.path.insert(0, str(REPO))
    if args.profiler_child:
        emit({"ok": True, **_profiler_child(torch)})
        return 0
    if args.tp_child:
        emit({"ok": True, **_tp_child(torch, args.tp_child)})
        return 0
    if args.checkpoint_child:
        emit({"ok": True, **_checkpoint_child(torch, args.checkpoint_child, bool(args.prewarm))})
        return 0
    if args.turns:
        emit(_turns(Path(args.turns).resolve(), args.turn_parts))
        print("chip_smoke: ran --turns only; no result line", file=sys.stderr)
        return 0
    from gridllm_torch.ops.kernels import KERNELS, by_name

    t_run = time.perf_counter()
    results: dict[str, dict] = {}
    for phase in ALL_PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        if phase == "build":
            out = phase_build()
        else:
            out = {"kernels": phase_kernels, "timing": phase_timing, "model": phase_model,
                   "serve": phase_serve, "worker": phase_worker, "sched": phase_sched,
                   "replay": phase_replay,
                   "spec": phase_spec, "checkpoint": phase_checkpoint,
                   "int8": phase_int8, "profiler": phase_profiler, "long": phase_long,
                   "tree": phase_tree, "kvx": phase_kvx, "gemma": phase_gemma,
                   "quant": phase_quant, "mixtral": phase_mixtral,
                   "gateway": phase_gateway, "controlplane": phase_controlplane,
                   "embed": phase_embed, "vision": phase_vision, "tp": phase_tp,
                   "ep": phase_ep}[phase](torch)
        out["phase_seconds"] = time.perf_counter() - t0
        emit(out)
        results[phase] = out

    if set(phases) != set(ALL_PHASES):
        print(f"chip_smoke: ran {phases} only; no result line", file=sys.stderr)
        return 0
    timing = {**results["timing"]["kernels"], **results["long"]["kernels"]}
    errs = {**results["kernels"]["max_abs_err_bf16"], **results["long"]["max_abs_err_bf16"]}
    launches = {**results["serve"]["launches"], **results["long"]["launches"]}
    int8 = results["int8"]
    timing["ragged_attention.int8"] = int8["timing"]["decode"]
    errs["ragged_attention.int8"] = int8["max_abs_err_bf16"]
    launches["ragged_attention.int8"] = int8["launches"]
    tree = results["tree"]
    timing["ragged_attention.tree"] = tree["timing"]
    errs["ragged_attention.tree"] = tree["max_abs_err_bf16"]
    launches["ragged_attention.tree"] = tree["launches"]
    # the seven kernels, ragged_attention's chunk kernel (csrc/ragged_attention.cu's
    # ragged_chunk_kernel, launched by the ragged_attention wrapper), then the
    # int8 and tree legs (their own launches, from the int8 serve and the tree
    # serve), then prefix_chunk's routes (csrc/per_phase_attention.cu): the
    # verify over slots and the tensor-core chunk
    rows = [(spec.name, spec) for spec in KERNELS]
    rows += [(f"ragged_attention.{leg}", by_name("ragged_attention"))
             for leg in ("chunk", "int8", "tree")]
    rows += [(leg, by_name("prefix_chunk")) for leg in _PER_PHASE_LEGS]
    from gridllm_torch.ops.cuda_kernels import _HEAD_DIMS

    line = [
        {"name": name, "route": "cuda", "source": spec.source,
         "replaces": spec.replaces.split(" ")[0], "head_dims": list(_HEAD_DIMS),
         "launches": launches[name],
         # the same kernel's launches under the port's scheduler, on the
         # int8 llama3:70b and mixtral serves, behind the port's gateway,
         # behind the scaled control plane, on the embeddings and on llava
         "launches_on": {p: results[p]["launches"].get(name, 0)
                         for p in ("sched", "quant", "mixtral", "gateway", "controlplane",
                                   "embed", "vision")},
         # each rank's launches in the two-rank group's serve (tp phase),
         # in its serves of the other families and modes, and in its
         # float32 cut modes (rank 0, rank 1)
         "launches_tp_ranks": {m: c.get(name, 0) for m, c in
                               results["tp"]["serve"]["group"]["launches"].items()},
         "launches_tp_serves": {
             serve: {m: c.get(name, 0) for m, c in v["group"]["launches"].items()}
             for serve, v in results["tp"]["serve"]["modes"].items()},
         "launches_tp_f32_modes": {
             mode: [r.get(name, 0) for r in v["launches_per_rank"]]
             for mode, v in results["tp"]["f32_cut"]["modes"].items() if mode != "embed"},
         # each rank's launches in the ep phase: the ep = 2 group's bf16
         # mixtral serve, and the float32 cuts of the four-rank world
         "launches_ep_ranks": {m: c.get(name, 0) for m, c in
                               results["ep"]["serve"]["group"]["launches"].items()},
         "launches_ep_f32_cuts": {
             cut: [r.get(name, 0) for r in v["launches_per_rank"]]
             for cut, v in results["ep"]["f32_cuts"].items()},
         "max_abs_err": errs[name], "ms": timing[name]["ms"],
         "plain_ms": timing[name]["plain_ms"], "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"], "library_ms": timing[name]["library_ms"]}
        for name, spec in rows]
    # the same kernels at D = 256 (the gemma phase): launches from the
    # gemma2:9b bf16 serve, its per-phase setting, or for a kernel off both
    # paths (paged_decode under speculation, the streamed prefill) the
    # float32 cut
    gemma = results["gemma"]
    sources = [("gemma serve", gemma["launches"]),
               ("gemma serve, per-phase", gemma["serve"]["per_phase"]["launches"]),
               *((f"gemma float32 cut, {mode}", counts)
                 for mode, counts in gemma["model"]["launches"].items())]
    for name, spec in rows:
        t = gemma["timing"][name]
        src, counts = next(((n, c) for n, c in sources if c.get(name)), sources[0])
        line.append({
            "name": f"{name}.d256", "route": "cuda", "source": spec.source,
            "replaces": spec.replaces.split(" ")[0], "head_dims": [GEMMA_D],
            "launches": counts.get(name, 0), "launches_from": src,
            "max_abs_err": gemma["max_abs_err_bf16"][name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    emit({"kernels": line, "total_seconds": time.perf_counter() - t_run})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
