"""Chat-message templating: structured messages → a model prompt.

Fixes reference defect SURVEY.md §2.8: `/ollama/api/chat` flattened messages
to `role: content` lines AND routed them down the generate path
(server/src/routes/ollama.ts:367-370). Here messages survive to the worker
(metadata.requestType == "chat") and are templated per-model:

- HF tokenizers with a chat_template use `apply_chat_template` (the
  model's own trained format).
- Otherwise (byte tokenizer / templateless): a llama3-style plain-text
  header framing that keeps roles distinguishable.

Multimodal `images` are collected by collect_images() and travel to the
engine on GenerationRequest.images — per-model capability is the ENGINE's
call (a non-vision model rejects loudly; the reference just forwarded them
to Ollama, OllamaService.ts:197-226).
"""

from __future__ import annotations


def collect_images(req) -> list[str]:
    """All base64 images on a request: top-level (generate path) plus
    per-message (chat path, incl. OpenAI content-array conversions)."""
    images = list(getattr(req, "images", None) or [])
    for m in getattr(req, "messages", None) or []:
        images.extend(m.get("images") or [])
    return images
