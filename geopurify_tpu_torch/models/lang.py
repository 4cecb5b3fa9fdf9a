"""CLIP-style language tower, hash tokenizer and class-name embedding.

Port of geopurify_tpu/models/lang.py: token + learned positional
embedding, causal post-norm transformer blocks (LayerNorm eps 1e-12,
QuickGELU MLP), final LayerNorm, pooled at the EOT position (the argmax id),
projected and L2-normalised. ``embed_class_names`` averages the CLIP prompt
templates per class. The hash tokenizer stands in for CLIP's BPE when no
vocabulary file is set; the BPE tokenizer itself waits for that file.
"""

from __future__ import annotations

import hashlib
import html
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from geopurify_tpu_torch.models.layers import Dense, LayerNorm, MultiHeadAttention
from geopurify_tpu_torch.models.student import truncated_normal_, variance_scaling_

# Standard CLIP ImageNet prompt templates (geopurify_tpu/models/lang.py:35)
PROMPT_TEMPLATES: Tuple[str, ...] = (
    '{}.', 'a photo of a {}.', 'a bad photo of a {}.', 'a photo of many {}.',
    'a sculpture of a {}.', 'a photo of the hard to see {}.',
    'a low resolution photo of the {}.', 'a rendering of a {}.',
    'graffiti of a {}.', 'a bad photo of the {}.', 'a cropped photo of the {}.',
    'a tattoo of a {}.', 'the embroidered {}.', 'a photo of a hard to see {}.',
    'a bright photo of a {}.', 'a photo of a clean {}.', 'a photo of a dirty {}.',
    'a dark photo of the {}.', 'a drawing of a {}.', 'a photo of my {}.',
    'the plastic {}.', 'a photo of the cool {}.', 'a close-up photo of a {}.',
    'a black and white photo of the {}.', 'a painting of the {}.',
    'a painting of a {}.', 'a pixelated photo of the {}.', 'a sculpture of the {}.',
    'a bright photo of the {}.', 'a cropped photo of a {}.', 'a plastic {}.',
    'a photo of the dirty {}.', 'a jpeg corrupted photo of a {}.',
    'a blurry photo of the {}.', 'a photo of the {}.', 'a good photo of the {}.',
    'a rendering of the {}.', 'a {} in a video game.', 'a photo of one {}.',
    'a doodle of a {}.', 'a close-up photo of the {}.', 'the origami {}.',
    'the {} in a video game.', 'a sketch of a {}.', 'a doodle of the {}.',
    'a origami {}.', 'a low resolution photo of a {}.', 'the toy {}.',
    'a rendition of the {}.', 'a photo of the clean {}.', 'a photo of a large {}.',
    'a rendition of a {}.', 'a photo of a nice {}.', 'a photo of a weird {}.',
    'a blurry photo of a {}.', 'a cartoon {}.', 'art of a {}.',
    'a sketch of the {}.', 'a embroidered {}.', 'a pixelated photo of a {}.',
    'itap of the {}.', 'a jpeg corrupted photo of the {}.', 'a good photo of a {}.',
    'a plushie {}.', 'a photo of the nice {}.', 'a photo of the small {}.',
    'a photo of the weird {}.', 'the cartoon {}.', 'art of the {}.',
    'a drawing of the {}.', 'a photo of the large {}.',
    'a black and white photo of a {}.', 'the plushie {}.', 'a dark photo of a {}.',
    'itap of a {}.', 'graffiti of the {}.', 'a toy {}.', 'itap of my {}.',
    'a photo of a cool {}.', 'a photo of a small {}.', 'a tattoo of the {}.',
)


def _clean(text: str) -> str:
    return " ".join(html.unescape(html.unescape(text)).strip().split())


# geopurify_tpu/models/lang.py:216
class HashTokenizer:
    """Deterministic stand-in with the CLIP interface: per-word md5 ids, SOT
    and EOT as the top two ids so EOT stays the argmax position."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        return [int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 2)
                for w in _clean(text).lower().split()]

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids [B, L], attention_mask [B, L]) int32, padded/truncated."""
        L = self.context_length
        ids = np.zeros((len(texts), L), np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(texts):
            toks = [self.sot] + self.encode(t)[: L - 2] + [self.eot]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


# geopurify_tpu/models/lang.py:258
def build_tokenizer(vocab_path: Optional[str] = None, context_length: int = 77,
                    vocab_size: int = 49408):
    """The hash tokenizer over ``vocab_size`` ids (the text tower's
    ``text.vocab_size``, so that SOT / EOT fall inside its embedding table;
    the JAX version always numbers them from 49408 — ROADMAP Queue 3). A BPE
    vocabulary file is not supported yet."""
    if vocab_path:
        raise NotImplementedError(
            "the CLIP BPE tokenizer is not ported yet (ROADMAP Queue 1 item 1, "
            "'ClipBPETokenizer'); unset text.tokenizer_vocab to use the hash tokenizer")
    return HashTokenizer(vocab_size=vocab_size, context_length=context_length)


class Embed(nn.Module):
    """flax nn.Embed: an ``embedding`` table [vocab, width]."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def forward(self, ids):
        return self.embedding[ids.long()]


# geopurify_tpu/models/lang.py:268
class TextTransformerBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm(width, eps=1e-12)
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln_2 = LayerNorm(width, eps=1e-12)
        self.mlp_c_fc = Dense(width, 4 * width, dtype)
        self.mlp_c_proj = Dense(4 * width, width, dtype)

    def forward(self, x, causal_mask):
        h = self.ln_1(x).to(self.dtype)
        x = x + self.attn(h, h, h, mask=causal_mask)
        h = self.mlp_c_fc(self.ln_2(x).to(self.dtype))
        h = h * torch.sigmoid(1.702 * h)          # QuickGELU
        return x + self.mlp_c_proj(h)


# geopurify_tpu/models/lang.py:295
class TextTransformer(nn.Module):
    """Causal CLIP text tower: [B, L] ids -> [B, L, width]."""

    def __init__(self, vocab_size: int = 49408, width: int = 512, layers: int = 12,
                 heads: int = 8, context_length: int = 77, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = layers
        self.token_embedding = Embed(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        for i in range(layers):
            self.add_module(f"resblocks{i}", TextTransformerBlock(width, heads, dtype))
        self.ln_final = LayerNorm(width, eps=1e-12)

    def forward(self, input_ids):
        L = input_ids.shape[1]
        x = (self.token_embedding(input_ids).to(self.dtype)
             + self.positional_embedding[None, :L].to(self.dtype))
        causal = torch.triu(torch.ones((L, L), dtype=torch.bool, device=x.device),
                            diagonal=1)[None, None]
        for i in range(self.layers):
            x = getattr(self, f"resblocks{i}")(x, causal)
        return self.ln_final(x).to(self.dtype)


# geopurify_tpu/models/lang.py:327
class LanguageEncoder(nn.Module):
    """Text tower + projection + logit scale."""

    def __init__(self, vocab_size: int = 49408, width: int = 512, layers: int = 12,
                 heads: int = 8, context_length: int = 77, dim_proj: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.lang_encoder = TextTransformer(vocab_size, width, layers, heads,
                                            context_length, dtype)
        self.lang_proj = nn.Parameter(torch.zeros(width, dim_proj))
        self.logit_scale = nn.Parameter(torch.ones(()))

    def forward(self, input_ids, norm: bool = True):
        """Pooled text embedding [B, dim_proj] at the EOT (argmax id) position."""
        x = self.lang_encoder(input_ids)
        eot = torch.argmax(input_ids, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot].float() @ self.lang_proj
        if norm:
            pooled = pooled / (torch.linalg.norm(pooled, dim=-1, keepdim=True) + 1e-7)
        return pooled

    def scale(self) -> torch.Tensor:
        return torch.exp(self.logit_scale)


def init_language_(lang: LanguageEncoder, generator: torch.Generator):
    """The Flax initialisers' distributions from ``generator``: embedding
    N(0, 1/width); Dense kernels LeCun-normal (truncated, fan-in); the
    positional embedding and ``lang_proj`` truncated N(0, 0.02^2); biases 0,
    LayerNorm scales 1, logit scale 1. Matches the distribution, not the
    bits, of ``LanguageEncoder.init``."""
    with torch.no_grad():
        for name, p in lang.named_parameters():
            if name.endswith("token_embedding.embedding"):
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[1]))
            elif name.endswith("positional_embedding") or name == "lang_proj":
                truncated_normal_(p, 0.02, generator)
            elif name == "logit_scale" or (name.endswith("weight") and p.dim() == 1):
                p.fill_(1.0)
            elif name.endswith("weight"):          # Dense [out, in]
                variance_scaling_(p, 1.0, p.shape[1], generator)
            else:
                p.zero_()
    return lang


# geopurify_tpu/models/lang.py:376
def class_name_prompts(class_names: Sequence[str], template: Optional[str] = None,
                       add_background: bool = True) -> List[str]:
    """The label strings fed to the text tower: each class in ``template``,
    then an unwrapped "background"."""
    names = [template.format(n) if template else n for n in class_names]
    if add_background:
        names.append("background")
    return names


# geopurify_tpu/models/lang.py:395
def embed_class_names(encode: Callable[[torch.Tensor], torch.Tensor], tokenizer,
                      class_names: Sequence[str], use_templates: bool = True,
                      add_background: bool = True, template: Optional[str] = None,
                      device="cpu") -> np.ndarray:
    """Per-class prompt-template-averaged, L2-normalised text embeddings,
    [n_cls (+1), dim_proj] f32, background last. ``encode`` maps [B, L] ids
    to [B, dim_proj] (a ``LanguageEncoder``)."""
    out = []
    for cls in class_name_prompts(class_names, template, add_background):
        clean = cls.replace("-other", "").replace("-merged", "").replace("-stuff", "")
        texts = [t.format(clean) for t in PROMPT_TEMPLATES] if use_templates else [clean]
        ids, _ = tokenizer(texts)
        with torch.no_grad():
            emb = encode(torch.from_numpy(ids).to(device)).float().cpu().numpy()
        mean = emb.mean(0)
        out.append(mean / (np.linalg.norm(mean) + 1e-12))
    return np.stack(out).astype(np.float32)
