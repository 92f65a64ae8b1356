"""Streaming detokenization for per-token callbacks.

Counterpart of ``paddle_tpu/serving/detok.py``. Wordpiece convention: a
``##``-prefixed piece glues to the previous one, anything else starts a
new whitespace-separated word. Unknown ids render as ``[UNK:<id>]``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

__all__ = ["StreamingDetokenizer"]


class StreamingDetokenizer:
    """Incremental id -> text converter. Stateless per call: the caller
    says whether this is the first piece of the stream."""

    def __init__(self, vocab: Union[Sequence[str], Mapping[str, int]]):
        if isinstance(vocab, Mapping):
            self._id_to_token: Dict[int, str] = {
                int(i): t for t, i in vocab.items()}
        else:
            self._id_to_token = dict(enumerate(vocab))

    def piece(self, token_id: int, is_first: bool) -> str:
        tok = self._id_to_token.get(int(token_id))
        if tok is None:
            tok = f"[UNK:{int(token_id)}]"
        if tok.startswith("##"):
            return tok[2:]
        return tok if is_first else " " + tok

    def decode(self, token_ids: Sequence[int]) -> str:
        return "".join(self.piece(t, i == 0)
                       for i, t in enumerate(token_ids))
