"""CLIP-style language tower, hash tokenizer and class-name embedding.

Port of geopurify_tpu/models/lang.py: token + learned positional
embedding, causal post-norm transformer blocks (LayerNorm eps 1e-12,
QuickGELU MLP), final LayerNorm, pooled at the EOT position (the argmax id),
projected and L2-normalised. ``embed_class_names`` averages the CLIP prompt
templates per class. Text is tokenized by CLIP's byte-pair tokenizer when
``text.tokenizer_vocab`` names the merges file, else by a hash tokenizer
with the same interface.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import math
import os
import re
import sys
import unicodedata
from functools import lru_cache
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


# geopurify_tpu/models/lang.py:72
@lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# geopurify_tpu/models/lang.py:88
def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


# geopurify_tpu/models/lang.py:97
def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


# geopurify_tpu/models/lang.py:102
def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


# the Unicode White_Space property, as a character-class body
_WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


@lru_cache()
def _letter_number_classes() -> Tuple[str, str]:
    """The bodies of the character classes ``\\p{L}`` and ``\\p{N}`` for the
    standard ``re`` module, which has no Unicode property escapes: every
    code point whose general category starts with L (letters) or N (Nd,
    and the Nl / No numerals that ``\\d`` misses), as ranges."""
    spans = {"L": [], "N": []}
    for cp in range(sys.maxunicode + 1):
        group = spans.get(unicodedata.category(chr(cp))[0])
        if group is None:
            continue
        if group and group[-1][1] == cp - 1:
            group[-1][1] = cp
        else:
            group.append([cp, cp])

    def body(ranges):
        return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                       for a, b in ranges)

    return body(spans["L"]), body(spans["N"])


# geopurify_tpu/models/lang.py:106
class ClipBPETokenizer:
    """The CLIP byte-pair tokenizer over a gzipped merges file
    (``bpe_simple_vocab_16e6.txt.gz``). The JAX version splits words with
    the third-party ``regex`` module's ``\\p{L}`` / ``\\p{N}``; here the same
    pattern is written for ``re`` with classes built from ``unicodedata``."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        # only real pair lines: a short merges file leaves trailing empty
        # lines that would become ()-merges and shift every id after them
        merges = [m for m in (tuple(m.split()) for m in merges) if len(m) == 2]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        letters, numbers = _letter_number_classes()
        # regex's \s is the White_Space property (re's also takes \x1c-\x1f)
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            rf"|[{letters}]+|[{numbers}]|[^{_WHITE_SPACE}{letters}{numbers}]+",
            re.IGNORECASE,
        )
        self.vocab_size = len(self.encoder)
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    # geopurify_tpu/models/lang.py:142
    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    # geopurify_tpu/models/lang.py:178
    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        # U+0345, a mark that case-folds to a letter, matches no branch of the
        # pattern under regex's IGNORECASE (it splits the text and is
        # dropped); re's would take it into the rest class
        for token in self.pat.findall(text.replace("\u0345", " ")):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return bpe_tokens

    # geopurify_tpu/models/lang.py:186
    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids [B, L], attention_mask [B, L]) int32, padded/truncated."""
        return _wrap(self, texts)

    # geopurify_tpu/models/lang.py:197
    def decode(self, ids: Sequence[int]) -> str:
        """Ids -> text, stopping at EOT and dropping SOT."""
        if not hasattr(self, "_decoder"):
            self._decoder = {v: k for k, v in self.encoder.items()}
            self._byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        parts = []
        for i in ids:
            i = int(i)
            if i == self.eot:
                break
            if i == self.sot:
                continue
            parts.append(self._decoder.get(i, ""))
        text = "".join(parts)
        raw = bytearray(self._byte_decoder[c] for c in text.replace("</w>", "\u0120"))
        return raw.decode("utf-8", errors="replace").replace("\u0120", " ").strip()


def _wrap(tokenizer, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """SOT + the first ``context_length - 2`` ids + EOT per text, zero-padded;
    (ids, mask) int32 [B, context_length]."""
    L = tokenizer.context_length
    ids = np.zeros((len(texts), L), np.int32)
    mask = np.zeros((len(texts), L), np.int32)
    for i, t in enumerate(texts):
        toks = [tokenizer.sot] + tokenizer.encode(t)[: L - 2] + [tokenizer.eot]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return ids, mask


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
                for w in _whitespace_clean(_basic_clean(text)).lower().split()]

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids [B, L], attention_mask [B, L]) int32, padded/truncated."""
        return _wrap(self, texts)


# geopurify_tpu/models/lang.py:258
def build_tokenizer(vocab_path: Optional[str] = None, context_length: int = 77,
                    vocab_size: int = 49408):
    """CLIP's BPE tokenizer over the merges file ``vocab_path``, or, when it
    is unset, the hash tokenizer over ``vocab_size`` ids (the text tower's
    ``text.vocab_size``, so that SOT / EOT fall inside its embedding table;
    the JAX version always numbers them from 49408 — ROADMAP Queue 3). A
    path that does not exist raises: the JAX version falls back to the hash
    tokenizer there, and a misspelt path gives meaningless text embeddings
    (ROADMAP Queue 3)."""
    if not vocab_path:
        return HashTokenizer(vocab_size=vocab_size, context_length=context_length)
    if not os.path.exists(vocab_path):
        raise FileNotFoundError(f"text.tokenizer_vocab: no BPE merges file at {vocab_path!r}")
    tk = ClipBPETokenizer(vocab_path, context_length)
    if tk.vocab_size > vocab_size:
        raise ValueError(f"{vocab_path}: {tk.vocab_size} BPE ids do not fit the text "
                         f"tower's text.vocab_size={vocab_size}")
    return tk


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
