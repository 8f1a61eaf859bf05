"""CLIP byte-pair-encoding tokenizer (openai/clip-vit-base-patch32 scheme).

Counterpart of medseg_tpu/interop/clip_tokenizer.py: the standard CLIP BPE
algorithm (lowercase + whitespace clean, CLIP's word regex, byte-level BPE
with end-of-word `</w>` markers, `<|startoftext|>`/`<|endoftext|>`
wrapping), with no vocabulary of its own.  The merges/vocab tables load from

  1. an explicit path (HF-format directory with vocab.json + merges.txt, or
     an OpenAI-format bpe *.txt.gz),
  2. `$MEDSEG_CLIP_VOCAB`,
  3. the local HF hub cache of openai/clip-vit-base-patch32 or
     CIDAS/clipseg-rd64-refined (both use the same tables).

The word regex needs the `regex` module, imported when a tokenizer is
built, since a machine may lack it.  tests/test_torch_clip.py holds the
ids against the JAX package's tokenizer on a synthetic vocabulary, and
against transformers' CLIPTokenizer where a real vocabulary is found.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT_LENGTH = 77

# CLIP's word-splitting pattern (needs the `regex` module for \p classes).
_PATTERN = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


def _basic_clean(text: str) -> str:
    try:  # ftfy is optional (absent in this build); prompts here are ASCII
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _find_cached_vocab() -> Optional[Path]:
    """Search the HF hub cache for CLIP vocab tables."""
    hub = Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")) / "hub"
    for repo in ("models--openai--clip-vit-base-patch32",
                 "models--CIDAS--clipseg-rd64-refined"):
        snaps = hub / repo / "snapshots"
        if snaps.is_dir():
            for snap in sorted(snaps.iterdir()):
                if (snap / "vocab.json").exists() and (snap / "merges.txt").exists():
                    return snap
    return None


class ClipTokenizer:
    def __init__(self, vocab_path: Optional[str] = None):
        """vocab_path: HF dir (vocab.json+merges.txt), an OpenAI .txt.gz, or
        None to search $MEDSEG_CLIP_VOCAB then the HF cache."""
        path = vocab_path or os.environ.get("MEDSEG_CLIP_VOCAB") or _find_cached_vocab()
        if path is None:
            raise FileNotFoundError(
                "no CLIP BPE vocabulary found: pass vocab_path, set "
                "$MEDSEG_CLIP_VOCAB, or populate the HF cache with "
                "openai/clip-vit-base-patch32")
        path = Path(path)
        if path.is_dir():
            self.encoder: Dict[str, int] = json.loads(
                (path / "vocab.json").read_text(encoding="utf-8"))
            lines = (path / "merges.txt").read_text(encoding="utf-8").splitlines()
            if lines and lines[0].startswith("#"):
                lines = lines[1:]
            merges = [tuple(l.split()) for l in lines if l.strip()]
        else:  # OpenAI bpe_simple_vocab_16e6.txt.gz format
            text = gzip.open(path, "rt", encoding="utf-8").read()
            lines = text.splitlines()
            merges = [tuple(l.split()) for l in lines[1:48895]]
            units = list(_bytes_to_unicode().values())
            vocab = units + [u + "</w>" for u in units]
            vocab += ["".join(m) for m in merges]
            vocab += [SOT, EOT]
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache: Dict[str, Tuple[str, ...]] = {}
        import regex  # here, not at import: a machine may lack it

        self._re = regex.compile(_PATTERN, regex.IGNORECASE)

    def _bpe(self, token: str) -> Tuple[str, ...]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return (token + "</w>",)
        while True:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        """Token ids for one string (no SOT/EOT wrapping)."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in self._re.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(mapped))
        return ids

    def __call__(self, texts: Sequence[str], pad_to: Optional[int] = None):
        """[N, L] int32 ids: SOT + tokens + EOT, EOT-padded to the longest
        sequence (matching HF `padding=True`, CLIP.py:40) or to `pad_to`."""
        import numpy as np

        rows = [[self.sot_id] + self.encode(t) + [self.eot_id] for t in texts]
        width = pad_to or max(len(r) for r in rows)
        if max(len(r) for r in rows) > CONTEXT_LENGTH:
            raise ValueError(f"prompt longer than {CONTEXT_LENGTH} CLIP tokens")
        out = np.full((len(rows), width), self.eot_id, np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out
