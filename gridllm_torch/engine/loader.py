"""Checkpoint loading and saving, and the host-RAM weight snapshot tier.

The counterpart of the JAX package's engine/loader.py for the families the
port serves (`model_class`: `Llama` for llama, qwen2 and qwen3, `Gemma2`
for gemma2, `Mixtral` for mixtral). The safetensors format is read and
written here, with no package for it (the card's machine has none):

- `_open_safetensors`: every ``*.safetensors`` of a directory (a sharded
  checkpoint is all of them), each file's 8-byte little-endian header
  length and JSON header, checked (dtypes BF16, F16 and F32; offsets
  inside the file, not overlapping). A tensor is read with `pread` from
  its offsets: into a CPU tensor of its own, or for a CUDA device through
  two pinned staging buffers of `STAGE_BYTES`, reading one while the
  other's copy to the card runs. The JAX package maps the files; on the
  card's machine the pages of a mapping stayed resident until it was
  closed, whatever the process advised (PERF.md), so a load held
  the whole checkpoint in host memory. Read this way it holds one tensor
  on the CPU path and the two staging buffers on the CUDA path.
- `load_checkpoint`: an HF-layout directory into the family's model, layer by
  layer through `models.hf_layout` (each tensor to the device as stored,
  transposed and converted there; with `quantize="int8"` each layer of a
  quant leaf is quantized as it is placed, so no whole float copy of the
  leaf reaches the device).
- `save_checkpoint`: a model to ``model.safetensors`` in the dtype asked
  for, plus the HF ``config.json`` of `ModelConfig.hf_config`, one tensor
  materialized on the host at a time. An int8 model is refused: the
  format holds float weights, and the JAX package has no int8 format.
- `WeightSnapshotTier`: an unloaded engine's weights parked as host
  tensors (pinned when the engine is on CUDA) keyed by checkpoint
  identity; a later load of the same identity restores them by a
  host-to-device copy instead of a disk read or a random init.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from collections import OrderedDict

import torch

from gridllm_torch.models.configs import ModelConfig
from gridllm_torch.models.gemma import Gemma2
from gridllm_torch.models.llama import Llama
from gridllm_torch.models.mixtral import Mixtral
from gridllm_torch.obs import default_registry
from gridllm_torch.utils.config import env_int
from gridllm_torch.utils.logging import get_logger

log = get_logger("engine.loader")

# safetensors dtype name ↔ (torch dtype, the dtype of the same width its
# bytes are read as: numpy and torch.frombuffer know no bfloat16)
_ST_DTYPES = {
    "BF16": (torch.bfloat16, torch.uint16),
    "F16": (torch.float16, torch.float16),
    "F32": (torch.float32, torch.float32),
}
_ST_NAMES = {dt: name for name, (dt, _) in _ST_DTYPES.items()}
STAGE_BYTES = 64 << 20   # one pinned staging buffer of a read to the card


class SafetensorsIndex:
    """HF tensor name → tensor, over the ``*.safetensors`` files of one
    directory (see the module docstring). Holds the files open until
    `close`."""

    def __init__(self, path: str):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {path}")
        self._fds: list[int] = []
        # name → (file index, byte offset, nbytes, torch dtype, read dtype, shape)
        self._entries: dict[str, tuple[int, int, int, torch.dtype, torch.dtype,
                                       tuple[int, ...]]] = {}
        self._stages: list[tuple[torch.Tensor, torch.cuda.Event]] | None = None
        try:
            for f in files:
                self._index_file(f)
        except BaseException:
            self.close()
            raise

    def _index_file(self, fname: str) -> None:
        size = os.path.getsize(fname)
        with open(fname, "rb") as fh:
            head = fh.read(8)
            if len(head) < 8:
                raise ValueError(f"{fname}: shorter than a safetensors header")
            (n,) = struct.unpack("<Q", head)
            if 8 + n > size:
                raise ValueError(f"{fname}: header of {n} bytes runs past the file")
            header = json.loads(fh.read(n))
        base, data_len = 8 + n, size - 8 - n
        spans = []
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            dt = meta.get("dtype")
            if dt not in _ST_DTYPES:
                raise ValueError(f"{fname}: tensor {name!r} has dtype {dt!r} "
                                 f"(supported: {sorted(_ST_DTYPES)})")
            torch_dt, read_dt = _ST_DTYPES[dt]
            shape = tuple(int(d) for d in meta["shape"])
            b, e = (int(x) for x in meta["data_offsets"])
            numel = 1
            for d in shape:
                numel *= d
            if not 0 <= b <= e <= data_len:
                raise ValueError(f"{fname}: tensor {name!r} offsets [{b}, {e}) run past "
                                 f"the {data_len} data bytes")
            if e - b != numel * torch_dt.itemsize:
                raise ValueError(f"{fname}: tensor {name!r} spans {e - b} bytes, its "
                                 f"shape {list(shape)} in {dt} needs "
                                 f"{numel * torch_dt.itemsize}")
            if name in self._entries:
                raise ValueError(f"{fname}: tensor {name!r} is in two files")
            spans.append((b, e, name))
            self._entries[name] = (len(self._fds), base + b, e - b, torch_dt, read_dt,
                                   shape)
        spans.sort()
        for (_, e0, n0), (b1, _, n1) in zip(spans, spans[1:]):
            if b1 < e0:
                raise ValueError(f"{fname}: tensors {n0!r} and {n1!r} overlap")
        self._fds.append(os.open(fname, os.O_RDONLY))

    def keys(self) -> list[str]:
        return list(self._entries)

    def _pread(self, fd: int, buf: torch.Tensor, offset: int) -> None:
        """Fill the uint8 CPU tensor `buf` from the file at `offset`."""
        view, done = memoryview(buf.numpy()), 0
        while done < len(view):
            got = os.preadv(fd, [view[done:]], offset + done)
            if got <= 0:
                raise OSError(f"short read at byte {offset + done}")
            done += got

    def get(self, name: str, device: str | torch.device = "cpu") -> torch.Tensor:
        """The tensor `name`, read from its file onto `device`."""
        if name not in self._entries:
            raise KeyError(f"tensor {name!r} not in the checkpoint")
        i, off, nbytes, torch_dt, read_dt, shape = self._entries[name]
        device = torch.device(device)
        raw = torch.empty(nbytes, dtype=torch.uint8, device=device)
        if device.type == "cpu":
            self._pread(self._fds[i], raw, off)
        elif nbytes:
            self._staged_read(self._fds[i], raw, off)
        return raw.view(read_dt).view(torch_dt).reshape(shape)

    def _staged_read(self, fd: int, raw: torch.Tensor, off: int) -> None:
        """Read into the device tensor `raw` through the two pinned staging
        buffers: a buffer is refilled only after its previous copy to the
        card has finished (its event), so reading overlaps copying."""
        if self._stages is None:
            self._stages = [(torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True),
                             torch.cuda.Event()) for _ in range(2)]
        pos, k = 0, 0
        while pos < raw.numel():
            n = min(STAGE_BYTES, raw.numel() - pos)
            buf, done = self._stages[k % 2]
            done.synchronize()
            self._pread(fd, buf[:n], off + pos)
            raw[pos:pos + n].copy_(buf[:n], non_blocking=True)
            done.record()
            pos, k = pos + n, k + 1

    def close(self) -> None:
        """Close the files; pending copies from the staging buffers finish
        first."""
        if self._stages is not None:
            for _, done in self._stages:
                done.synchronize()
            self._stages = None
        for fd in self._fds:
            os.close(fd)
        self._fds = []


def _open_safetensors(path: str) -> SafetensorsIndex:
    return SafetensorsIndex(path)


def _save_safetensors(fname: str, tensors: dict[str, torch.Tensor],
                      dtype: torch.dtype | None = None) -> int:
    """Write `tensors` (any device, any strides) as one safetensors file, each
    converted to `dtype` (None: as it is) and materialized on the host one at
    a time. Returns the bytes written."""
    metas, offset = {}, 0
    for name, t in tensors.items():
        dt = dtype or t.dtype
        if dt not in _ST_NAMES:
            raise ValueError(f"{name!r}: dtype {dt} cannot be written "
                             f"(supported: {sorted(_ST_DTYPES)})")
        nbytes = t.numel() * dt.itemsize
        metas[name] = {"dtype": _ST_NAMES[dt], "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header = json.dumps({"__metadata__": {"format": "pt"}, **metas},
                        separators=(",", ":")).encode()
    header += b" " * (-len(header) % 8)   # the data starts 8-byte aligned
    with open(fname, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for name, t in tensors.items():
            host = t.to(dtype or t.dtype).contiguous().cpu()
            f.write(host.view(torch.uint8).numpy().data if host.numel() else b"")
    return 8 + len(header) + offset


# the torch model of each family this package serves
_FAMILIES = {"llama": Llama, "qwen2": Llama, "qwen3": Llama, "gemma2": Gemma2,
             "mixtral": Mixtral}


def model_class(cfg: ModelConfig) -> type[Llama]:
    """The torch model of cfg's family (the JAX engine's `_model_module`);
    raises for a family this package has no model for. Each class owns
    its HF layout contract (`name_map()`, the JAX loader's `_name_map`)."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} has no torch model")
    return _FAMILIES[cfg.family]


def load_checkpoint(cfg: ModelConfig, path: str, dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cuda", quantize: str | None = None,
                    model: Llama | None = None, ragged_attention: bool = True) -> Llama:
    """Load an HF-layout safetensors directory into the family's model
    (`model`, or a new one of `dtype` on `device`, int8 weights with
    `quantize="int8"`). Each tensor is read onto the model's device as
    stored, then transposed and converted (or, for an int8 leaf,
    quantized) there into its slot."""
    cls = model_class(cfg)
    if model is None:
        model = cls(cfg, dtype=dtype, device=device, ragged_attention=ragged_attention,
                    quantize=quantize)
    elif model.quantize != quantize:
        raise ValueError(f"load_checkpoint(quantize={quantize!r}) into a model built "
                         f"with quantize={model.quantize!r}")
    idx = _open_safetensors(path)
    try:
        model.params_from_hf(lambda name: idx.get(name, model.device))
    finally:
        idx.close()
    log.debug("checkpoint loaded", model=cfg.name, path=path)
    return model


def save_checkpoint(model: Llama, cfg: ModelConfig, path: str,
                    dtype: torch.dtype = torch.bfloat16) -> int:
    """Write `model` as an HF-layout checkpoint: ``model.safetensors`` in
    `dtype` plus the ``config.json`` of `cfg.hf_config()`, which
    `config_from_hf_dir` (and transformers) read back. Returns the bytes
    of the weights file. An int8 model raises: there is no int8 checkpoint
    format to write (the JAX package has none either), so save the
    unquantized model and load it with quantize="int8"."""
    from gridllm_torch.models import hf_layout

    if model.quantize:
        raise ValueError(f"save_checkpoint: {cfg.name} has {model.quantize} weights; a "
                         "checkpoint holds float weights and there is no int8 format (the "
                         "JAX package has none): save the unquantized model")
    os.makedirs(path, exist_ok=True)
    tensors = hf_layout.to_hf_tensors(model.params_tree(), cfg, model.name_map())
    n = _save_safetensors(os.path.join(path, "model.safetensors"), tensors, dtype)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg.hf_config(torch_dtype=str(dtype).removeprefix("torch.")), f, indent=2)
    return n


# ---------------------------------------------------------------------------
# Host-RAM weight snapshot tier: unloading a model parks its weights as host
# tensors keyed by checkpoint identity; a later load of the same identity
# restores them by a host-to-device copy. Capacity-bounded LRU; a miss falls
# through to the checkpoint or init path, never an error.

_SNAP_BYTES = default_registry().gauge(
    "gridllm_weight_snapshot_bytes",
    "Host RAM held by parked weight snapshots (engine/loader.py); "
    "bounded by GRIDLLM_WEIGHT_SNAPSHOT_BYTES.",
)
_SNAP_MODELS = default_registry().gauge(
    "gridllm_weight_snapshot_models",
    "Distinct checkpoint identities resident in the weight snapshot "
    "tier (engine/loader.py).",
)
_SNAP_EVENTS = default_registry().counter(
    "gridllm_weight_snapshot_events_total",
    "Weight snapshot tier activity by event: park, hit (restore served "
    "from host RAM), miss (load fell through to disk/init), evict "
    "(LRU capacity pressure).",
    ("event",),
)


class _Snapshot(dict):
    """Parked weights by name: views into one host block of exactly their
    bytes (each view 256-byte aligned), registered with CUDA as pinned
    memory when the weights lie on CUDA, so a restore is a DMA. (The caching
    pinned allocator rounds every block up to a power of two: llama3.2:1b's
    2.47 GB would take 4.7 GB.) Unpinned when the last reference goes: a
    restorer holds the snapshot until its copies have finished."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        sizes = {name: t.numel() * t.element_size() for name, t in params.items()}
        self.nbytes = sum(sizes.values())
        self.block = torch.empty(sum(-(-n // 256) * 256 for n in sizes.values()),
                                 dtype=torch.uint8)
        self._pinned = False
        cuda = any(t.is_cuda for t in params.values())
        if cuda and self.block.numel():
            err = int(torch.cuda.cudart().cudaHostRegister(
                self.block.data_ptr(), self.block.numel(), 0))
            self._pinned = err == 0
            if not self._pinned:
                log.warning("weight snapshot left pageable: cudaHostRegister failed",
                            error=err)
        pos = 0
        for name, t in params.items():
            view = self.block[pos:pos + sizes[name]].view(t.dtype).view(t.shape)
            view.copy_(t, non_blocking=self._pinned)
            self[name] = view
            pos += -(-sizes[name] // 256) * 256
        if cuda:
            torch.cuda.synchronize()

    def __del__(self):
        if self._pinned:
            try:
                torch.cuda.cudart().cudaHostUnregister(self.block.data_ptr())
            except Exception:  # noqa: BLE001 — interpreter shutdown
                pass


class WeightSnapshotTier:
    """LRU of host-side weights (name → CPU tensor), keyed by checkpoint
    identity. An entry survives `restore` (weights are immutable: one
    snapshot can warm many loads); capacity pressure evicts the
    least-recently-touched identity, and a snapshot larger than the
    capacity is dropped. Thread-safe: parks run on a worker's admin
    tasks, restores on engine construction."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = max(int(capacity_bytes), 0)
        self._entries: OrderedDict[str, tuple[dict[str, torch.Tensor], int]] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.parks = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def enabled(self) -> bool:
        return self.capacity_bytes > 0

    def park(self, key: str, params: dict[str, torch.Tensor]) -> bool:
        """Copy `params` to host RAM under `key`. False when the tier is
        disabled or the snapshot alone exceeds the capacity."""
        if not self.enabled:
            return False
        size = sum(t.numel() * t.element_size() for t in params.values())
        if size > self.capacity_bytes:
            log.info("weight snapshot too large for tier; dropped", key=key, bytes=size,
                     capacity=self.capacity_bytes)
            return False
        host = _Snapshot(params)
        with self._lock:
            if key in self._entries:
                _, old = self._entries.pop(key)
                self._bytes -= old
            while self._bytes + size > self.capacity_bytes and self._entries:
                old_key, (_, old_size) = self._entries.popitem(last=False)
                self._bytes -= old_size
                self.evictions += 1
                _SNAP_EVENTS.inc(event="evict")
                log.info("weight snapshot evicted", key=old_key, bytes=old_size)
            self._entries[key] = (host, host.nbytes)
            self._bytes += host.nbytes
            self.parks += 1
            self._publish()
        _SNAP_EVENTS.inc(event="park")
        log.info("weight snapshot parked", key=key, bytes=size)
        return True

    def restore(self, key: str) -> dict[str, torch.Tensor] | None:
        """The host weights under `key`, or None on a miss. The entry is
        kept (moved to most recent); callers must not modify the tensors."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                _SNAP_EVENTS.inc(event="miss")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        _SNAP_EVENTS.inc(event="hit")
        return entry[0]

    def _publish(self) -> None:
        _SNAP_BYTES.set(self._bytes)
        _SNAP_MODELS.set(len(self._entries))

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacityBytes": self.capacity_bytes,
                "parks": self.parks,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


_tier: WeightSnapshotTier | None = None
_tier_lock = threading.Lock()


def weight_snapshot_tier() -> WeightSnapshotTier:
    """The process-wide tier, sized from GRIDLLM_WEIGHT_SNAPSHOT_BYTES at
    first touch (every engine of a worker shares one host-RAM budget)."""
    global _tier
    with _tier_lock:
        if _tier is None:
            _tier = WeightSnapshotTier(env_int("GRIDLLM_WEIGHT_SNAPSHOT_BYTES"))
        return _tier


def reset_weight_snapshot_tier() -> None:
    """Forget the process-wide tier (the next touch reads the env again)."""
    global _tier
    with _tier_lock:
        _tier = None
