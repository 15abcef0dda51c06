"""The vision path of the PyTorch port against the JAX package at float32.

tiny-llava (CLIP tower of 3 layers, 4 patches per image): the JAX llava
parameters carried across with `params_from_jax`; the vision tower,
`encode_images` and `splice_embeds` at chunk offsets within 1e-4 of the
largest magnitude, the forward over spliced embeddings; engines of both
packages greedy-streaming one image through the bucket prefill and two
images through chunks (an image span across a chunk boundary), with
ragged attention on (mixed steps) and off (`prefill_chunk`), token for
token equal; the four refusals with the JAX wording; the prefix cache
skipped for image requests. Then the port's host preprocessing:
`decode_png` bit-equal to PIL on images PIL writes (RGB, RGBA, gray,
gray+alpha, palette at 1, 2, 4 and 8 bits) and on images written here with
each of the five row filters; interlaced and 16-bit images refused by
name; `preprocess_images` within one 8-bit step after normalization of the
JAX package's; JPEG without PIL refused by name. Then llava checkpoints in
both HF namings against the JAX loader.
"""

import base64
import io
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.engine import images as TIMG
from gridllm_torch.engine import loader as TLOAD
from gridllm_torch.models import configs as TCFG
from gridllm_torch.models.llava import Llava
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.engine import images as JIMG
from gridllm_tpu.engine import loader as JLOAD
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import llava as JV

REL = 1e-4
# one 8-bit step after the CLIP normalization (the smallest std)
PIXEL_STEP = 1 / 255 / 0.26130258
ENGINE = dict(model="tiny-llava", max_slots=2, page_size=8, num_pages=64,
              max_pages_per_slot=16, prefill_buckets=(16, 64), prefill_chunk=16,
              dtype="float32", seed=1)
OPTS = {"temperature": 0, "num_predict": 10}
IMG = 250   # tiny-llava's image token


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pil_png(arr, mode=None, **save) -> bytes:
    im = Image.fromarray(arr)
    if mode is not None:
        im = im.convert(mode) if mode != "P" else im.quantize(save.pop("colors"))
    buf = io.BytesIO()
    im.save(buf, format="PNG", **save)
    return buf.getvalue()


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


def _rgb(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the port's model on them, cfg) for tiny-llava."""
    jcfg, tcfg = JCFG.get_config("tiny-llava"), TCFG.get_config("tiny-llava")
    params = JV.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    model = Llava(tcfg, dtype=torch.float32, device="cpu").params_from_jax(_np(params))
    return params, model, jcfg


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_tower_encode_and_splice_match_jax(pair):
    params, model, cfg = pair
    vc = cfg.vision_cfg
    px = np.random.default_rng(0).normal(size=(2, 3, 28, 28)).astype(np.float32)
    _close(model.vision_tower(torch.from_numpy(px)).numpy(),
           np.asarray(JV.vision_tower(params, vc, jnp.asarray(px))))
    emb = np.array(JV.encode_images(params, cfg, jnp.asarray(px)))
    _close(model.encode_images(torch.from_numpy(px)).numpy(), emb)
    flat = emb.reshape(-1, emb.shape[-1])
    ids = np.array([1, 2] + [IMG] * vc.num_patches + [3] + [IMG] * vc.num_patches + [4, 5],
                   np.int32)
    whole = np.asarray(JV.splice_embeds(params, cfg, jnp.asarray(ids), jnp.asarray(flat)))
    c = 4
    for s0 in range(0, len(ids), c):   # chunks cut the image spans
        off = int((ids[:s0] == IMG).sum())
        part = model.splice_embeds(torch.from_numpy(ids[s0:s0 + c]), torch.from_numpy(flat),
                                   off).numpy()
        np.testing.assert_array_equal(part, whole[s0:s0 + c])


def test_forward_over_spliced_embeds_matches_jax(pair):
    params, model, cfg = pair
    px = np.random.default_rng(1).normal(size=(1, 3, 28, 28)).astype(np.float32)
    ids = np.array([1, 7, 9] + [IMG] * 4 + [11, 12, 13], np.int32)
    flat = JV.encode_images(params, cfg, jnp.asarray(px)).reshape(-1, cfg.hidden_size)
    embeds = JV.splice_embeds(params, cfg, jnp.asarray(ids), flat)
    want = np.asarray(JV.forward(params, cfg, jnp.asarray(ids)[None], embeds=embeds[None]))
    tflat = model.encode_images(torch.from_numpy(px)).reshape(-1, cfg.hidden_size)
    tembeds = model.splice_embeds(torch.from_numpy(ids), tflat)
    got = model.forward(torch.from_numpy(ids)[None], embeds=tembeds[None]).numpy()
    _close(got, want)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

IMAGES = [_b64(_pil_png(_rgb(1, 30, 40))), _b64(_pil_png(_rgb(2, 50, 20)))]
# BOS, 13 text tokens, an image (its 4 tokens across the chunk boundary at
# 16), 5 text tokens, an image, 10 text tokens: 37 tokens in 3 chunks
TWO = [256] + list(range(65, 78)) + [IMG] + list(range(80, 85)) + [IMG] + list(range(90, 100))
CASES = {"one_image_bucket": dict(prompt="describe this", images=IMAGES[:1]),
         "two_images_chunked": dict(prompt_ids=TWO, images=IMAGES)}


def _engines(monkeypatch, ragged: str, **kw):
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", ragged)
    je = JEngine(JConfig(**ENGINE, **kw))
    te = TEngine(TConfig(**ENGINE, **kw), device="cpu", params=_np(je.params))
    return je, te


@pytest.mark.parametrize("ragged", ["1", "0"], ids=["ragged", "per_phase"])
def test_engine_streams_match_jax(monkeypatch, ragged):
    """Greedy streams token for token equal to the JAX engine's: one image
    through the bucket prefill, two images through three chunks (mixed
    steps with ragged attention, prefill_chunk without); the images
    matter (others give another stream)."""
    je, te = _engines(monkeypatch, ragged)
    for name, kw in CASES.items():
        want = je.generate(JRequest(id=name, options=dict(OPTS), **kw))
        got = te.generate(TRequest(id=name, options=dict(OPTS), **kw))
        assert want.done_reason in ("stop", "length") and not got.error
        assert got.token_ids == want.token_ids, name
        assert got.prompt_eval_count == want.prompt_eval_count
        assert got.context == want.context
    other = dict(CASES["two_images_chunked"], images=IMAGES[::-1])
    swapped = te.generate(TRequest(id="swapped", options=dict(OPTS), **other))
    assert swapped.token_ids != got.token_ids


# (request, what the JAX engine's error must equal)
REFUSALS = {
    "non_vision_model": ("tiny-llama", dict(prompt="x", images=["aGVsbG8="])),
    "placeholder_count": ("tiny-llava", dict(prompt_ids=[1, IMG, 2, IMG],
                                             images=["aGVsbG8="])),
    "context_without_images": ("tiny-llava", dict(prompt_ids=[1, 2] + [IMG] * 4 + [3])),
    "truncation_into_image": ("tiny-llava", dict(prompt_ids=[1] + [IMG] + list(range(3, 40)),
                                                 images=IMAGES[:1],
                                                 options={"num_ctx": 12, "num_predict": 2})),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax_wording(case):
    model, kw = REFUSALS[case]
    kw = {"options": {"num_predict": 2}, **kw}
    cfg = dict(ENGINE, model=model)
    out = {}
    for kind, eng, cls in (("jax", JEngine(JConfig(**cfg)), JRequest),
                           ("torch", TEngine(TConfig(**cfg), device="cpu"), TRequest)):
        out[kind] = eng.generate(cls(id=case, **kw))
    assert out["torch"].done_reason == out["jax"].done_reason == "error"
    assert out["torch"].error == out["jax"].error, out["torch"].error
    assert not out["torch"].retryable


def test_image_requests_skip_the_prefix_cache_and_bad_images_fail():
    te = TEngine(TConfig(**ENGINE), device="cpu")
    kw = dict(prompt="a prompt long enough to fill a page or two of the pool",
              images=IMAGES[:1], options=dict(OPTS))
    first = te.generate(TRequest(id="a", **kw))
    again = te.generate(TRequest(id="b", **kw))
    assert again.token_ids == first.token_ids and again.cached_tokens == 0
    assert te.alloc.cached_pages == 0
    bad = te.generate(TRequest(id="bad", prompt="x", images=["aGVsbG8="], options=dict(OPTS)))
    assert bad.done_reason == "error" and not bad.retryable and "image" in bad.error


# ---------------------------------------------------------------------------
# host preprocessing
# ---------------------------------------------------------------------------


def _png(samples: np.ndarray, ctype: int, depth: int = 8, filters=(0,), palette=None,
         interlace: int = 0) -> bytes:
    """A PNG written here: samples [H, W*channels] (already packed for
    depth < 8), each row filtered with filters[row % len(filters)]."""
    h = samples.shape[0]
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    rows = samples.astype(np.int32)
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for r in range(h):
        cur, kind = rows[r], filters[r % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 4:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = [0, left, prev, (left + prev) // 2][kind]
        out += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    w = samples.shape[1] * 8 // depth // {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                           0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return data + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


def _pil_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


PIL_WRITTEN = {
    "rgb": lambda a: _pil_png(a),
    "rgba": lambda a: _pil_png(a, "RGBA"),
    "gray": lambda a: _pil_png(a, "L"),
    "gray_alpha": lambda a: _pil_png(a, "LA"),
    "gray_1bit": lambda a: _pil_png(a, "1"),
    **{f"palette_{n}": (lambda a, n=n: _pil_png(a, "P", colors=n)) for n in (2, 4, 16, 256)},
}


@pytest.mark.parametrize("kind", sorted(PIL_WRITTEN))
def test_decode_png_bit_equal_to_pil(kind):
    raw = PIL_WRITTEN[kind](_rgb(5, 23, 37))
    np.testing.assert_array_equal(TIMG.decode_png(raw), _pil_rgb(raw))


def test_decode_png_every_row_filter_bit_equal_to_pil():
    rng = np.random.default_rng(6)
    filters = (0, 1, 2, 3, 4, 4, 3, 2, 1)
    cases = [
        (rng.integers(0, 256, (18, 11 * 3)), 2, 8, None),           # RGB
        (rng.integers(0, 256, (18, 9 * 4)), 6, 8, None),            # RGBA
        (rng.integers(0, 256, (18, 13)), 0, 8, None),               # gray
        (rng.integers(0, 256, (18, 7 * 2)), 4, 8, None),            # gray+alpha
        (rng.integers(0, 256, (18, 5)), 3, 4, rng.integers(0, 256, (16, 3))),  # 4-bit palette
        (rng.integers(0, 256, (18, 3)), 0, 2, None),                # 2-bit gray
    ]
    for samples, ctype, depth, palette in cases:
        raw = _png(samples, ctype, depth, filters, palette)
        np.testing.assert_array_equal(TIMG.decode_png(raw), _pil_rgb(raw))


def test_decode_png_refuses_interlaced_and_16_bit():
    samples = np.random.default_rng(7).integers(0, 256, (4, 12))
    with pytest.raises(TIMG.ImageError, match="interlaced"):
        TIMG.decode_png(_png(samples, 2, interlace=1))
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 900).save(buf, format="PNG")
    with pytest.raises(TIMG.ImageError, match="16-bit"):
        TIMG.decode_png(buf.getvalue())


def test_preprocess_within_one_step_of_jax():
    """The CLIP pipeline on PNGs of several shapes and modes (both resize
    directions, up and down) and on a JPEG (through PIL here)."""
    payloads = [_pil_png(_rgb(8, 50, 41)), _pil_png(_rgb(9, 20, 90), "RGBA"),
                _pil_png(_rgb(10, 300, 200), "P", colors=64), _pil_png(_rgb(11, 17, 17), "L")]
    buf = io.BytesIO()
    Image.fromarray(_rgb(12, 40, 60)).save(buf, format="JPEG")
    payloads.append(buf.getvalue())
    b64 = [_b64(p) for p in payloads]
    for size in (28, 336):
        got = TIMG.preprocess_images(b64, size)
        want = JIMG.preprocess_images(b64, size)
        assert got.shape == want.shape == (len(b64), 3, size, size)
        np.testing.assert_allclose(got, want, rtol=0, atol=PIXEL_STEP)


def test_non_png_without_pil_is_refused_by_name(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(_rgb(13, 8, 8)).save(buf, format="JPEG")
    png = _b64(_pil_png(_rgb(14, 9, 9)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(TIMG.ImageError, match="JPEG"):
        TIMG.preprocess_images([_b64(buf.getvalue())], 28)
    assert TIMG.preprocess_images([png], 28).shape == (1, 3, 28, 28)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("naming", ["published", "flat"])
def test_checkpoint_in_both_namings_loads_like_jax(tmp_path, pair, naming):
    """The port's writer in one HF naming; the JAX loader and the port's
    read it back to the parameters it was written from."""
    params, model, cfg = pair
    tcfg = TCFG.get_config("tiny-llava")
    if naming == "published":
        TLOAD.save_checkpoint(model, tcfg, str(tmp_path), dtype=torch.float32)
    else:
        _save(model, tmp_path, naming)
    want = _np(params)
    got = _np(JLOAD.load_checkpoint(cfg, str(tmp_path), dtype=jnp.float32))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    back = TLOAD.load_checkpoint(TCFG.config_from_hf_dir("local", str(tmp_path)),
                                 str(tmp_path), dtype=torch.float32, device="cpu")
    assert isinstance(back, Llava)
    for (n, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), n


# published llava-hf names → transformers >= 4.52's
FLAT = {"language_model.model.": "model.language_model.",
        "language_model.lm_head.": "lm_head.",
        "vision_tower.": "model.vision_tower.",
        "multi_modal_projector.": "model.multi_modal_projector."}


def _save(model, path, naming):
    """The port's checkpoint, its tensors renamed to transformers >= 4.52's
    flat llava names."""
    import json

    def flat(name):
        pfx = next(p for p in FLAT if name.startswith(p))
        return FLAT[pfx] + name[len(pfx):]

    tensors = {flat(k): v for k, v in model.hf_tensors().items()}
    assert naming == "flat" and "lm_head.weight" in tensors
    TLOAD._save_safetensors(str(path / "model.safetensors"), tensors, torch.float32)
    (path / "config.json").write_text(json.dumps(model.cfg.hf_config()))
