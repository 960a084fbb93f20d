"""The port's CLIP tokenizer (``openess_tpu_torch/models/fcclip/tokenizer.py``)
against the JAX package's, id for id, on the synthetic merges file of
``tests/test_tokenizer.py`` and on one that merges inside the VILD
prompts' words: the 504 prompts of the 36-class vocabulary, and non-ASCII
text (composed and decomposed accents, fractions, superscripts, Roman
numerals, CJK, ``_``, HTML entities, the long s, U+0345, the whitespace
the two pattern engines class differently). The JAX file splits with the
``regex`` package, which the card machine lacks; the port's module
imports with ``regex`` and ``ftfy`` blocked."""
import gzip
import os
import subprocess
import sys
import unicodedata

import numpy as np
import pytest

from openess_tpu.models.fcclip import tokenizer as jtok
from openess_tpu.models.fcclip.meta import DSEC_USER_CLASSES
from openess_tpu.models.fcclip.meta import prepare_class_names
from openess_tpu_torch.models.fcclip import tokenizer as ptok
from test_tokenizer import MERGES
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "café", unicodedata.normalize("NFD", "café"), "CAFÉ au lait",
    "½ cup", "x² + y²", "Ⅻ o'clock", "chapter ⅻ", "東京タワー", "北京 traffic",
    "snake_case_name", "&amp; &lt;tag&gt; &amp;amp;", "it's we're they'll",
    "IT'S I'M YOU'D", "'ſ and 'ſt", "ͅ alone, aͅb", "a\x1cb\x1dc\x85d",
    "tab\tnew\nline　wide nbsp", "<|startoftext|>hi<|endoftext|>",
    "!!<|endoftext|>", "123 4.5e6 ٣٤", "emoji 🚗🚲 ok", "naïve façade",
    "ß ẞ ﬁ", "ǅungla", "   ", "",
]


def _merges_file(path, merges):
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: test"] + [" ".join(m) for m in merges]))
    return str(path)


def _prompt_merges():
    """Merges that rebuild the prompts' common words, in order, on top of
    the synthetic file's."""
    merges = list(MERGES)
    for word in ("photo", "there", "the", "scene", "small", "large",
                 "medium", "this", "is"):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            merges.append((parts[0], parts[1]))
            parts = [parts[0] + parts[1]] + parts[2:]
    return merges


@pytest.fixture(scope="module", params=["test_tokenizer", "prompt_words"])
def pair(request, tmp_path_factory):
    merges = MERGES if request.param == "test_tokenizer" else _prompt_merges()
    path = _merges_file(tmp_path_factory.mktemp("bpe") / "m.txt.gz", merges)
    return jtok.SimpleTokenizer(path), ptok.SimpleTokenizer(path)


def test_vild_prompts_tokenize_as_jax(pair):
    jt, pt = pair
    _, _, prompts = prepare_class_names(DSEC_USER_CLASSES)
    assert len(prompts) == 504
    got = pt(prompts)
    assert got.dtype == np.int32 and got.shape == (504, 77)
    np.testing.assert_array_equal(got, jt(prompts))
    assert (pt.sot, pt.eot) == (jt.sot, jt.eot)
    assert pt.encoder == jt.encoder


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_text_tokenizes_as_jax(pair, text):
    jt, pt = pair
    assert pt.encode(text) == jt.encode(text)
    low = jtok.whitespace_clean(jtok.basic_clean(text)).lower()
    assert ptok.whitespace_clean(ptok.basic_clean(text)).lower() == low
    assert ptok.pre_tokenize(low) == jt.pat.findall(low)


def test_long_prompts_are_cut_at_77_with_eot(pair):
    jt, pt = pair
    texts = ["a photo of a " * 40, "x"]
    np.testing.assert_array_equal(pt(texts), jt(texts))
    assert pt(texts)[0, -1] == pt.eot


def test_imports_without_regex_or_ftfy():
    code = ("import sys\n"
            "sys.modules['regex'] = None\nsys.modules['ftfy'] = None\n"
            "from openess_tpu_torch.models.fcclip import tokenizer\n"
            "print(tokenizer.pre_tokenize(\"½ café's ⅻ_x\"))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "['½', 'café', \"'s\", 'ⅻ', '_', 'x']"
