"""Tokenizer wrapper (port of ``self_forcing_tpu/tokenizer.py``).

A HuggingFace tokenizer behind the reference's text cleaning modes
('whitespace' | 'lower' | 'canonicalize') and fixed-length padding.
``transformers`` is imported when a tokenizer is made, never with this
module: the cleaning functions need nothing but the standard library.
ftfy is not assumed; ``basic_clean`` approximates its ``fix_text`` with
unicode NFKC and HTML unescaping, which covers the shipped configs
(clean='whitespace').
"""
from __future__ import annotations

import html
import re
import string
import unicodedata
from typing import List

import numpy as np
import torch


def basic_clean(text: str) -> str:
    text = unicodedata.normalize("NFKC", text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str, keep_punctuation_exact_string=None) -> str:
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(str.maketrans("", "", string.punctuation))
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


class HuggingfaceTokenizer:
    """``name``: a local directory (or hub id) of the tokenizer, e.g.
    google/umt5-xxl; ``seq_len``: the fixed padded length (512 for Wan's
    T5).  Calling it returns (ids, mask), int64 tensors [B, seq_len]."""

    def __init__(self, name: str, seq_len: int | None = None,
                 clean: str | None = "whitespace", **kwargs):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                "HuggingfaceTokenizer needs the 'transformers' package, "
                "which is not installed; feed token ids to the T5 encoder "
                "instead") from e
        self.name = name
        self.seq_len = seq_len
        self.clean = clean
        self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
        self.vocab_size = self.tokenizer.vocab_size

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text

    def __call__(self, sequence: List[str] | str, return_mask: bool = True,
                 **kwargs):
        if isinstance(sequence, str):
            sequence = [sequence]
        sequence = [self._clean(s) for s in sequence]
        kwargs.setdefault("padding",
                          "max_length" if self.seq_len else "longest")
        kwargs.setdefault("truncation", bool(self.seq_len))
        if self.seq_len:
            kwargs.setdefault("max_length", self.seq_len)
        out = self.tokenizer(sequence, return_tensors="np", **kwargs)
        ids = torch.from_numpy(out["input_ids"].astype(np.int64))
        mask = torch.from_numpy(out["attention_mask"].astype(np.int64))
        if return_mask:
            return ids, mask
        return ids
