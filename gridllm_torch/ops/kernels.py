"""KERNELS: the port's registry of hand-written CUDA kernels.

Each entry names one kernel of `ops/cuda_kernels.py`, the TPU kernel of the
JAX package it replaces, its plain PyTorch version (the oracle it is held
to, on the CPU in the tests and on the card in chip_smoke.py), the
tolerance of that comparison, the CPU test that owns the differential
against the JAX package, and the chip_smoke.py phase that runs it on the
card. Tolerances are the bf16 bound for attention and exact for the KV
writes (data movement), as in the JAX package's registry; float32 runs
hold the attention kernels to 1e-3.

Pure data: importable without torch.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str         # wrapper in ops/cuda_kernels.py
    source: str       # CUDA source under gridllm_torch/csrc/
    replaces: str     # TPU kernel: "file:line function"
    plain: str        # "module:function" plain PyTorch version
    rtol: float       # bf16 tolerance against the plain version
    atol: float
    test: str         # owning CPU differential test
    smoke_phase: str  # chip_smoke.py phases that run it on the card
    # legs beside the kernel's main path, each counted in
    # cuda_kernels.LEG_LAUNCHES["<name>.<leg>"]: (leg, operands and what
    # they add, owning CPU differential test); same plain version and
    # tolerances
    legs: tuple[tuple[str, str, str], ...] = ()


KERNELS: tuple[KernelSpec, ...] = (
    KernelSpec(
        name="flash_prefill",
        source="gridllm_torch/csrc/flash_prefill.cu",
        replaces="gridllm_tpu/ops/pallas_kernels.py:129 flash_prefill",
        plain="attention:attention_prefill_ref",
        rtol=3e-2, atol=3e-2,
        test="tests/test_torch_attention.py::test_prefill_ref_matches_flash_kernel",
        smoke_phase="kernels, timing, model, serve, long",
    ),
    KernelSpec(
        name="flash_prefill_streamed",
        source="gridllm_torch/csrc/flash_prefill.cu",
        replaces="gridllm_tpu/ops/pallas_kernels.py:268 flash_prefill_streamed",
        plain="attention:attention_prefill_blocked_ref",
        rtol=3e-2, atol=3e-2,
        test="tests/test_torch_long_context.py::test_blocked_ref_matches_jax_streamed_kernel",
        smoke_phase="kernels, timing, long",
    ),
    KernelSpec(
        name="paged_decode",
        source="gridllm_torch/csrc/per_phase_attention.cu",
        replaces="gridllm_tpu/ops/pallas_kernels.py:479 paged_decode",
        plain="attention:paged_attention_decode_ref",
        rtol=3e-2, atol=3e-2,
        test="tests/test_torch_legacy_attention.py::test_decode_matches_jax",
        smoke_phase="kernels, timing, model, serve",
    ),
    KernelSpec(
        name="prefix_chunk",
        source="gridllm_torch/csrc/per_phase_attention.cu",
        replaces="gridllm_tpu/ops/pallas_kernels.py:739 prefix_chunk",
        plain="attention:_prefix_chunk_ref",
        rtol=3e-2, atol=3e-2,
        test="tests/test_torch_legacy_attention.py::test_prefix_chunk_matches_jax",
        smoke_phase="kernels, timing, model, serve",
        legs=(
            # its routes, each a launch of its own on the card
            ("chunk", "one chunk of a bf16 q on a bf16 pool: prefix_chunk_wgmma_kernel "
             "(the wgmma + TMA chunk body), start and total read on the device",
             "tests/test_torch_per_phase_plan.py::test_chunk_plan_walk_matches_jax_prefix_chunk"),
            ("chunk_cores", "one chunk of a float32 q or another page size, on the CUDA "
             "cores (prefix_chunk_kernel)",
             "tests/test_torch_legacy_attention.py::test_prefix_chunk_matches_jax"),
            ("slots", "prefix_chunk_slots: the per-phase verify, every slot in one launch "
             "(plain version paged_attention_verify_ref), the group body split over pages",
             "tests/test_torch_per_phase_plan.py::test_verify_split_merge_matches_jax"),
        ),
    ),
    KernelSpec(
        name="ragged_attention",
        source="gridllm_torch/csrc/ragged_attention.cu",
        replaces="gridllm_tpu/ops/pallas_kernels.py:1168 ragged_attention",
        plain="attention:ragged_paged_attention_ref",
        rtol=3e-2, atol=3e-2,
        test="tests/test_torch_attention.py::test_ragged_ref_matches_ragged_kernel",
        smoke_phase="kernels, timing, serve, int8, tree",
        legs=(
            ("int8", "k_scale/v_scale: an int8 pool; the groups dequantize each row by "
             "its float32 scale after the load, a bf16 chunk converts each int8 tile "
             "exactly to bf16 in shared memory and scales the logits and "
             "probabilities by the rows' scales in float32",
             "tests/test_torch_kv_int8.py::test_ragged_on_int8_pool_matches_jax"),
            ("tree", "tree_pos/tree_bits: the group's <= 32 tokens are token-tree "
             "nodes at logical positions length + depth, fresh columns masked by "
             "ancestor bitmasks",
             "tests/test_torch_spec_tree.py::test_tree_attention_matches_jax"),
            # the regions, each a route of its own on the card
            ("chunk", "the chunk region of a bf16 q on a bf16 or an int8 pool: "
             "ragged_chunk_kernel (wgmma + TMA), a launch of its own",
             "tests/test_torch_ragged_plan.py::test_chunk_plan_walk_matches_jax_ref"),
            ("chunk_cores", "the chunk region of a float32 q or another page size, on the "
             "CUDA cores in ragged_attention_kernel beside the groups",
             "tests/test_torch_attention.py::test_ragged_ref_matches_ragged_kernel"),
            ("group", "the group region, split over pages, partials merged in the launch",
             "tests/test_torch_ragged_plan.py::test_split_merge_ref_matches_jax_ref"),
        ),
    ),
    KernelSpec(
        name="paged_write_decode",
        source="gridllm_torch/csrc/paged_write.cu",
        replaces="gridllm_tpu/ops/pallas_kernels.py:1404 paged_write_decode",
        plain="kvcache:write_decode",
        rtol=0.0, atol=0.0,
        test="tests/test_torch_kvcache.py::test_write_decode_matches_jax",
        smoke_phase="kernels, timing, serve",
    ),
    KernelSpec(
        name="paged_write_chunk",
        source="gridllm_torch/csrc/paged_write.cu",
        replaces="gridllm_tpu/ops/pallas_kernels.py:1497 paged_write_chunk",
        plain="kvcache:write_prefill",
        rtol=0.0, atol=0.0,
        test="tests/test_torch_kvcache.py::test_write_prefill_matches_jax",
        smoke_phase="kernels, timing, serve",
    ),
)

# float32 tolerance of the attention kernels against their plain versions
F32_TOL = 1e-3


def by_name(name: str) -> KernelSpec:
    for k in KERNELS:
        if k.name == name:
            return k
    raise KeyError(f"unknown kernel {name!r}")
