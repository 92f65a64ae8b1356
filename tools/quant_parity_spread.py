"""How far the port's predictors and the JAX package's drift apart on the
aligned tiny BERT of ``tests/test_torch_quant.py``, over several batches:
the measurement behind that file's ``PREDICTOR_TOL``.

For each predictor (bf16 alone, int8, int8 + bf16, and static PTQ with
each package's own calibrated scales) it prints, per batch, the max and
mean absolute difference of the scores over the largest JAX score and
the share of argmaxes that agree. Then it holds three wrong port
predictors against the JAX int8 + bf16 one, the readings a faulty bf16
int8 predictor would give: bf16 without int8, int8 with float32
output, and int8 + bf16 with the bias added in float32 before the cast
to bf16 (one rounding fewer than ``quant_matmul.py:205-206``). Last,
the layer-level readings of the sound and the bias-in-f32 linear in
bf16 against the JAX ``int8_linear`` on ``test_int8_linear_equals_jax``'s
inputs: how many outputs differ. Run on the CPU from the root of a
checkout::

    JAX_PLATFORMS=cpu python tools/quant_parity_spread.py [--batches 6]
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _bias_in_f32(x, w_q, w_scale, bias=None, act_scale=None):
    """``int8_linear`` with the bias added in float32 and one cast to
    x's dtype after it: a plausible fault of a bf16 int8 linear."""
    import torch
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    lead = x.shape[:-1]
    x_q, a_s = qm.quantize_per_tensor(x.reshape(-1, x.shape[-1]), act_scale)
    y = qm.int8_matmul(x_q, w_q, w_scale, a_s, out_dtype=torch.float32)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*lead, w_q.shape[1])


def _layer_level() -> None:
    import jax.numpy as jnp
    import torch
    from paddle_tpu.ops.pallas import quant_matmul as jq
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    for static in (False, True):
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 5, 256)).astype(np.float32)
        w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
        b = rng.standard_normal(128).astype(np.float32)
        act = 0.021 if static else None
        jwq, jws = jq.quantize_per_channel(jnp.asarray(w))
        ref = np.asarray(jq.int8_linear(
            jnp.asarray(x).astype(jnp.bfloat16), jwq, jws,
            bias=jnp.asarray(b), act_scale=act)).astype(np.float32)
        wq, ws = qm.quantize_per_channel(torch.from_numpy(w))
        for label, f in (("sound", qm.int8_linear),
                         ("bias in f32", _bias_in_f32)):
            got = f(torch.from_numpy(x).bfloat16(), wq, ws,
                    bias=torch.from_numpy(b), act_scale=act)
            got = got.float().numpy()
            print(f"layer bf16 {'static' if static else 'dynamic'} "
                  f"{label}: {int((got != ref).sum())} of {got.size} "
                  f"outputs differ from JAX's, max "
                  f"{np.abs(got - ref).max():.3e}", flush=True)


def main(batches: int) -> None:
    import jax
    import torch
    jax.config.update("jax_platforms", "cpu")
    from paddle_tpu import inference as jinf
    from paddle_tpu.core.flags import flag_scope
    from paddle_tpu.jit.input_spec import InputSpec
    from paddle_tpu_torch import inference, slim
    import test_torch_quant as T
    specs = [InputSpec((2, 64), "int32")] * 3 + [InputSpec((2, 6), "int32")]
    calib = [T._bert_batch(512, seed=s) for s in (1, 2)]

    def bf16_pair(jm, pm):
        jc = jinf.Config.from_layer(jm, specs)
        tc = inference.Config.from_layer(pm, specs)
        for c in (jc, tc):
            c.enable_tpu_bf16()
        return jinf.create_predictor(jc), inference.create_predictor(tc)

    def report(label, jp, tp):
        for seed in range(batches):
            batch = T._bert_batch(512, seed=seed + 10)
            ref = jp.run(list(batch))[0]
            got = tp.run(list(batch))[0]
            d = np.abs(got - ref)
            big = np.abs(ref).max()
            agree = (got.argmax(-1) == ref.argmax(-1)).mean()
            print(f"{label:24s} batch {seed}: max {d.max() / big:.3e} "
                  f"mean {d.mean() / big:.3e} argmax {agree:.3f}",
                  flush=True)

    with flag_scope("pallas_interpret", True):
        for mode in ("bf16", "int8", "int8+bf16", "ptq"):
            jm, pm = T._bert_pair(T.ALIGNED, scan=mode != "ptq")
            if mode == "bf16":
                jp, tp = bf16_pair(jm, pm)
            elif mode == "ptq":
                # each package calibrates its own scales, none carried
                jp = T._jax_predictor(jm, mode, specs, calib)
                pm.eval()
                ptq = slim.PostTrainingQuantization(pm)
                for b in calib:
                    ptq.collect(*map(torch.from_numpy, b))
                tp = inference.create_predictor(
                    inference.Config.from_layer(ptq.run(), specs))
            else:
                jp = T._jax_predictor(jm, mode, specs)
                tp = T._port_predictor(pm, mode, specs)
            report(mode, jp, tp)
        # wrong port predictors against JAX's int8 + bf16
        for wrong in ("bf16, no int8", "int8, f32 out",
                      "int8+bf16, bias in f32"):
            jm, pm = T._bert_pair(T.ALIGNED)
            jp = T._jax_predictor(jm, "int8+bf16", specs)
            if wrong == "bf16, no int8":
                tc = inference.Config.from_layer(pm, specs)
                tc.enable_tpu_bf16()
                report(f"wrong: {wrong}", jp, inference.create_predictor(tc))
            elif wrong == "int8, f32 out":
                report(f"wrong: {wrong}", jp,
                       T._port_predictor(pm, "int8", specs))
            else:
                saved, slim.int8_linear = slim.int8_linear, _bias_in_f32
                try:
                    report(f"wrong: {wrong}", jp,
                           T._port_predictor(pm, "int8+bf16", specs))
                finally:
                    slim.int8_linear = saved
    _layer_level()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=6)
    main(ap.parse_args().batches)
