"""Decoding: BeamSearchDecoder, dynamic_decode and gather_tree, PyTorch
port.

Counterpart of ``paddle_tpu/nn/decode.py`` (reference:
``fluid/layers/rnn.py`` Decoder, BeamSearchDecoder, dynamic_decode and
``operators/gather_tree_op.cc``). The JAX package runs the decode as one
``lax.scan`` over ``max_step_num`` steps and the backtrace as a reversed
scan; the port runs both as Python loops over the same fixed-shape
batch, with the same semantics: every step keeps ``B * beam`` rows,
finished beams extend only with eos at zero cost and keep their score,
the top ``beam`` of ``beam * V`` candidates (ties to the lower index,
as ``lax.top_k``) pick each row's parent and token, and the cell states
follow their parent beam.

Cell states are any nest of dicts, lists, tuples and namedtuples whose
leaves are tensors with a leading batch dimension (:func:`tree_map`
maps the tensors and leaves every other leaf as it is).
"""

from __future__ import annotations

import collections
from typing import Callable

import torch

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree",
           "tree_map"]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every tensor of a nest of dicts, lists, tuples
    and namedtuples; the nest's structure is kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def gather_tree(ids, parents):
    """Backtrace beam parents into full sequences (reference:
    ``operators/gather_tree_op.cc``). ``ids``/``parents``
    ``[T, B, beam]`` -> ``[T, B, beam]``: column ``k`` of the result is
    the path that ends in beam ``k`` at the last step."""
    ids = torch.as_tensor(ids)
    parents = torch.as_tensor(parents, device=ids.device).long()
    T, B, beam = ids.shape
    out = torch.empty_like(ids)
    beam_idx = torch.arange(beam, device=ids.device).expand(B, beam)
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(ids[t], 1, beam_idx)
        beam_idx = torch.gather(parents[t], 1, beam_idx)
    return out


class Decoder:
    """Base decode contract (reference: rnn.py Decoder)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a step cell (reference: rnn.py BeamSearchDecoder).

    ``cell(inputs [B*beam], states) -> (cell_out, new_states)``;
    ``output_fn(cell_out)`` (when given, else ``cell_out`` itself) must be
    the vocabulary logits ``[B*beam, V]``; ``embedding_fn(ids)``, when
    given, turns the token ids into the cell's inputs."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ["scores", "predicted_ids", "parent_ids"])
    StateWrapper = collections.namedtuple(
        "StateWrapper", ["cell_states", "log_probs", "finished", "lengths"])

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[B, ...]`` -> ``[B*beam, ...]`` (encoder outputs etc.)."""
        return tree_map(lambda a: torch.repeat_interleave(a, beam_size,
                                                          dim=0), x)

    def _split(self, a, B):
        """``[B*beam, ...]`` -> ``[B, beam, ...]``"""
        return a.reshape((B, self.beam_size) + tuple(a.shape[1:]))

    def initialize(self, initial_cell_states):
        """Tile the cell states to the beam; beam 0 live, the rest at
        -1e9."""
        states = self.tile_beam_merge_with_batch(initial_cell_states,
                                                 self.beam_size)
        leaves = _leaves(states)
        if not leaves:
            raise ValueError(
                "BeamSearchDecoder needs initial cell states: pass "
                "dynamic_decode(decoder, inits=<cell state nest with a "
                "[batch, ...] leading dim>, ...), e.g. the encoder's "
                "final hidden state")
        dev = leaves[0].device
        B = leaves[0].shape[0] // self.beam_size
        log_probs = torch.tensor(
            [[0.0] + [-1e9] * (self.beam_size - 1)],
            dtype=torch.float32, device=dev).repeat(B, 1)
        finished = torch.zeros((B, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((B, self.beam_size), dtype=torch.int32,
                              device=dev)
        init_inputs = torch.full((B * self.beam_size,), self.start_token,
                                 dtype=torch.int64, device=dev)
        return init_inputs, self.StateWrapper(states, log_probs, finished,
                                              lengths), finished

    def step(self, time, inputs, states, **kwargs):
        if self.embedding_fn is not None:
            inputs = self.embedding_fn(inputs)
        cell_out, next_cell_states = self.cell(inputs, states.cell_states,
                                               **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        V = cell_out.shape[-1]
        B = states.log_probs.shape[0]
        beam = self.beam_size
        dev = cell_out.device
        step_lp = self._split(torch.log_softmax(cell_out.float(), dim=-1),
                              B)                              # [B, bm, V]
        # finished beams extend only with eos, at zero cost
        eos_only = torch.full((V,), -1e9, dtype=torch.float32, device=dev)
        eos_only[self.end_token] = 0.0
        step_lp = torch.where(states.finished[..., None], eos_only,
                              step_lp)
        total = states.log_probs[..., None] + step_lp         # [B, bm, V]
        flat = total.reshape(B, beam * V)
        # lax.top_k order: descending, ties to the lower index
        top_scores, top_idx = torch.sort(flat, dim=-1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :beam], top_idx[:, :beam]
        parent = torch.div(top_idx, V, rounding_mode="floor")
        token = top_idx % V
        was_finished = torch.gather(states.finished, 1, parent)
        finished = was_finished | (token == self.end_token)
        lengths = torch.gather(states.lengths, 1, parent) \
            + (~was_finished).to(torch.int32)
        # the cell states follow their parent beam
        flat_parent = (parent + (torch.arange(B, device=dev)
                                 * beam)[:, None]).reshape(-1)
        next_cell_states = tree_map(
            lambda a: a.index_select(0, flat_parent.to(a.device)),
            next_cell_states)
        outputs = self.OutputWrapper(top_scores, token.to(torch.int32),
                                     parent.to(torch.int32))
        next_states = self.StateWrapper(next_cell_states, top_scores,
                                        finished, lengths)
        return outputs, next_states, token.reshape(-1), finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """``outputs`` fields stacked ``[T, B, beam]`` -> backtraced
        ids."""
        return gather_tree(outputs.predicted_ids,
                           outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run a decoder for ``max_step_num`` steps (reference: rnn.py
    dynamic_decode). Finished beams are masked, not retired, so every
    step has the same shape. Returns ``(outputs, final_states)``, or
    ``(outputs, final_states, sequence_lengths)`` with
    ``return_length``; for :class:`BeamSearchDecoder` ``outputs`` is the
    backtraced ids ``[B, T, beam]`` (``[T, B, beam]`` when
    ``output_time_major``)."""
    if max_step_num is None:
        raise ValueError("max_step_num is required (a fixed step count, "
                         "as the JAX package's scan needs)")
    inputs, states, finished = decoder.initialize(inits)
    steps = []
    for t in range(int(max_step_num)):
        outputs, states, inputs, next_finished = decoder.step(
            t, inputs, states, **kwargs)
        finished = next_finished if decoder.tracks_own_finished \
            else next_finished | finished
        steps.append(outputs)
    if torch.is_tensor(steps[0]):
        stacked = torch.stack(steps)
    else:                       # a namedtuple of per-step tensors
        stacked = type(steps[0])(*(torch.stack(f) for f in zip(*steps)))
    seq_len = getattr(states, "lengths", None)
    out, final_states = decoder.finalize(stacked, states, seq_len)
    if not output_time_major:
        out = out.transpose(0, 1)
    if return_length:
        return out, final_states, seq_len
    return out, final_states
