"""The port's tokenizer wrapper and text cleaning against the JAX
package's, on a tiny word-level tokenizer built here offline with
``tokenizers`` and saved where ``AutoTokenizer`` loads it: the same ids
and masks (padding to ``seq_len``, truncation past it, padding to the
longest without one) under each cleaning mode; the cleaning functions
equal on awkward text; a clear ImportError without ``transformers``."""
import sys

import numpy as np
import pytest
import torch

from self_forcing_tpu import tokenizer as jtok
from self_forcing_tpu_torch import tokenizer as ttok

WORDS = ["a", "red", "fox", "runs", "in", "the", "snow", "at", "night",
         "tokyo", "street", "neon", "&", "rain", ",", "."]
PROMPTS = ["A red fox runs in the snow", "the  fox\tat night",
           "a red fox runs in the snow at night in the tokyo street, neon "
           "rain",   # longer than seq_len: truncated
           "Tokyo&amp;rain_at night ."]
TEXTS = ["  Café ＡＢ &amp;amp; x ", "snake_case_words, ok!",
         "a\n\nb\t c", "&lt;tag&gt; Hello__World.", ""]


def save_tiny_tokenizer(path):
    """A word-level tokenizer (pad 0, eos 1 appended T5-style, unk 2)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(WORDS)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Sequence(
        [pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Punctuation()])
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>",
                            eos_token="</s>", unk_token="<unk>"
                            ).save_pretrained(str(path))


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok")
    save_tiny_tokenizer(path)
    return str(path)


@pytest.mark.parametrize("seq_len", [8, None])
@pytest.mark.parametrize("clean", ["whitespace", "lower", "canonicalize",
                                   None])
def test_ids_and_masks_match_jax(tok_dir, monkeypatch, seq_len, clean):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    jt = jtok.HuggingfaceTokenizer(tok_dir, seq_len=seq_len, clean=clean)
    tt = ttok.HuggingfaceTokenizer(tok_dir, seq_len=seq_len, clean=clean)
    assert tt.vocab_size == jt.vocab_size
    j_ids, j_mask = jt(PROMPTS)
    t_ids, t_mask = tt(PROMPTS)
    assert t_ids.dtype == t_mask.dtype == torch.int64
    np.testing.assert_array_equal(t_ids.numpy(), j_ids)
    np.testing.assert_array_equal(t_mask.numpy(), j_mask)
    if seq_len:
        assert t_ids.shape == (len(PROMPTS), seq_len)
        assert t_mask[1].sum() < seq_len and t_mask[2].sum() == seq_len
    np.testing.assert_array_equal(tt(PROMPTS[1], return_mask=False).numpy(),
                                  jt(PROMPTS[1], return_mask=False))


@pytest.mark.parametrize("text", TEXTS)
def test_cleaning_matches_jax(text):
    assert ttok.basic_clean(text) == jtok.basic_clean(text)
    assert ttok.whitespace_clean(text) == jtok.whitespace_clean(text)
    assert ttok.canonicalize(text) == jtok.canonicalize(text)
    assert ttok.canonicalize(text, "__") == jtok.canonicalize(text, "__")


def test_missing_transformers_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        ttok.HuggingfaceTokenizer("google/umt5-xxl", seq_len=512)
