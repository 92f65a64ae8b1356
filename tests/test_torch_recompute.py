"""The port's activation recompute (``distributed.fleet.utils.recompute``)
against the plain forward, as ``tests/test_recompute.py`` holds the JAX
one: gradient parity, the same dropout masks in the forward and the
recomputed forward (the port replays its explicit generator's seed
words), ``recompute_sequential``, every policy name and alias, and a
``use_recompute`` GPT step equal to the plain step, with and without
dropout. Gradients are compared bit for bit where the recomputed
forward runs the same ops (1e-6 relative where it does not)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.random import dropout_generator
from paddle_tpu_torch.distributed.fleet.utils import (
    recompute, recompute_sequential, resolve_checkpoint_policy)
from paddle_tpu_torch.distributed.fleet.utils.recompute import (
    _POLICY_ALIASES, _POLICY_NAMES)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForPretraining,
                                     GPTPretrainingCriterion, gpt_tiny)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW


def _mlp(seed=7):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                               torch.nn.Linear(32, 16))


def _grads(blk, x, wrap):
    blk.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_(True)
    out = wrap(blk, x)
    out.sum().backward()
    return (out.detach(), x.grad, {k: p.grad.clone()
                                   for k, p in blk.named_parameters()})


def test_grad_parity():
    blk = _mlp()
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 16)
                         .astype(np.float32))
    ref = _grads(blk, x, lambda b, t: b(t))
    got = _grads(blk, x, lambda b, t: recompute(b, t))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for k in ref[2]:
        assert torch.equal(got[2][k], ref[2][k]), k


def test_parameters_get_gradients_without_an_input_that_needs_one():
    """The JAX semantics: every parameter the segment reaches gets its
    gradient, whether or not an input requires one."""
    blk = torch.nn.Linear(8, 8)
    x = torch.randn(4, 8)
    torch.nn.functional.relu(recompute(blk, x)).sum().backward()
    assert blk.weight.grad is not None and blk.bias.grad is not None


def test_dropout_masks_replay_in_the_recomputed_forward():
    """Dropout inside the segment draws its seed words from the active
    generator: the recomputed forward replays them, so the gradient is
    the plain forward's bit for bit, and the generator moves on exactly
    as far as the plain forward moved it."""
    blk = _mlp(9)

    def seg(t):
        return F.dropout(blk(t), 0.5)

    x = torch.from_numpy(np.random.RandomState(2).randn(4, 16)
                         .astype(np.float32))
    runs = []
    for wrap in (lambda t: seg(t), lambda t: recompute(seg, t)):
        g = torch.Generator().manual_seed(5)
        blk.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_(True)
        with dropout_generator(g):
            out = wrap(xx)
        out.sum().backward()
        runs.append((out.detach(), xx.grad, blk[0].weight.grad.clone(),
                     g.get_state()))
    (o1, gx1, gw1, s1), (o2, gx2, gw2, s2) = runs
    assert torch.equal(o1, o2) and torch.equal(gx1, gx2)
    assert torch.equal(gw1, gw2) and torch.equal(s1, s2)
    assert (o1 == 0).any()


def test_recompute_sequential_param_grads():
    torch.manual_seed(12)
    layers = [torch.nn.Linear(8, 8), torch.nn.ReLU(), torch.nn.Linear(8, 8),
              torch.nn.ReLU(), torch.nn.Linear(8, 4)]
    x = torch.randn(4, 8)
    ref = torch.nn.Sequential(*layers)(x)
    out = recompute_sequential({"segments": 2}, layers, x)
    assert torch.equal(out, ref)
    out.sum().backward()
    for lyr in layers:
        for _, p in lyr.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.parametrize("name",
                         sorted(_POLICY_NAMES + tuple(_POLICY_ALIASES)))
def test_every_policy_name_gives_the_plain_gradients(name):
    """Each JAX policy name and alias resolves (the ``nothing_saveable``
    family to full recompute) and gives the plain gradients within 1e-6
    relative."""
    fn = resolve_checkpoint_policy(name)
    full = _POLICY_ALIASES.get(name, name) == "nothing_saveable"
    assert (fn is None) == full
    blk = _mlp(3)
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 16)
                         .astype(np.float32))
    ref = _grads(blk, x, lambda b, t: b(t))
    got = _grads(blk, x, lambda b, t: recompute(b, t, policy=name))
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=0)
    for k in ref[2]:
        torch.testing.assert_close(got[2][k], ref[2][k], rtol=1e-6, atol=0)


def test_dots_policies_save_the_products_and_recompute_the_rest():
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    for name, bmm in (("dots_saveable", True),
                      ("dots_with_no_batch_dims_saveable", False)):
        fn = resolve_checkpoint_policy(name)
        assert fn(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
        assert fn(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
        assert (fn(None, aten.bmm.default) == CheckpointPolicy.MUST_SAVE) \
            == bmm
        assert fn(None, aten.relu.default) == \
            CheckpointPolicy.PREFER_RECOMPUTE
    fn = resolve_checkpoint_policy("everything_saveable")
    assert fn(None, aten.relu.default) == CheckpointPolicy.MUST_SAVE


def test_unknown_policy_raises_the_jax_message():
    from paddle_tpu.distributed.fleet.utils.recompute import (
        resolve_checkpoint_policy as jax_resolve)
    with pytest.raises(ValueError) as ours:
        resolve_checkpoint_policy("save_everything_twice")
    with pytest.raises(ValueError) as ref:
        jax_resolve("save_everything_twice")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("dropout,amp", [(0.0, False), (0.1, False),
                                         (0.1, True)])
def test_use_recompute_losses_equal_the_plain_step(dropout, amp):
    """Three GPT steps with ``use_recompute`` (full, and dots-only
    saving) equal the plain step's losses and parameters bit for bit,
    dropout and AMP O1 included: the recomputed blocks replay their
    masks and the autocast state of their first forward."""
    from paddle_tpu_torch.amp import auto_cast

    def run(use_rc, policy=None):
        cfg = gpt_tiny(vocab_size=128, hidden_size=64, num_layers=2,
                       num_heads=4, max_position_embeddings=64,
                       hidden_dropout_prob=dropout,
                       attention_dropout_prob=dropout,
                       use_recompute=use_rc, recompute_policy=policy)
        m = GPTForPretraining(cfg, device="cpu", seed=11)
        crit = GPTPretrainingCriterion()

        def loss_fn(layer, i, t):
            with auto_cast(enable=amp):
                return crit(layer(i), t)
        step = TrainStep(m, loss_fn, AdamW(1e-3, parameters=m.parameters()),
                         seed=4)
        ids = np.random.RandomState(4).randint(0, 128, (2, 32)) \
            .astype(np.int32)
        return [float(step(ids, ids)) for _ in range(3)], m.state_dict()
    plain, sd = run(False)
    for policy in (None, "dots_saveable"):
        got, sd2 = run(True, policy)
        assert got == plain, (policy, got, plain)
        for k in sd:
            assert torch.equal(sd[k], sd2[k]), (policy, k)
    assert plain[2] < plain[0]


def test_encoder_use_recompute_matches_the_plain_stack():
    from paddle_tpu_torch.nn.layers.transformer import (
        TransformerEncoder, TransformerEncoderLayer)
    torch.manual_seed(0)
    enc = TransformerEncoder(TransformerEncoderLayer(32, 2, 64, dropout=0.0,
                                                     device="cpu"), 2)
    x = torch.randn(2, 8, 32)
    ref = _grads(enc, x, lambda b, t: b(t))
    enc.use_recompute = True
    got = _grads(enc, x, lambda b, t: b(t))
    assert torch.equal(got[0], ref[0])
    for k in ref[2]:
        torch.testing.assert_close(got[2][k], ref[2][k], rtol=1e-6, atol=0)
