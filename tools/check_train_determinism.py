"""Whether a BERT-base O1 training step repeats itself bit for bit on
the card, and whether chip_smoke phase 19's resume check holds.

    python3 tools/check_train_determinism.py [--repeats N]

Run from the root of the checkout to check, on a machine with one CUDA
card (it imports ``paddle_tpu_torch`` and ``chip_smoke`` from the
working directory). Builds the kernels (phase 1), then (1) two fresh
steps from the same seed take three steps each on phase 10's batch and
the script prints every parameter that differs between them and by how
much, and (2) runs phase 19's ``save_train_step`` / ``load_train_step``
check (``_res_train``) ``--repeats`` times, printing whether each run's
resumed parameters were bit-equal to the uninterrupted run's. Exits
non-zero when anything differed.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("check_train_determinism.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    cs.phase_card()
    params = []
    for _ in range(2):
        _, _, step, batch = cs._encoder_setup("bert")
        losses = [float(step(*batch)) for _ in range(3)]
        params.append((losses, {k: v.detach().clone()
                                for k, v in step.layer.named_parameters()}))
        del step
    (l1, p1), (l2, p2) = params
    diff = {k: (p1[k] - p2[k]).abs().max().item() for k in p1}
    bad = sorted(((k, v) for k, v in diff.items() if v), key=lambda kv: -kv[1])
    print(f"two fresh BERT-base O1 runs of 3 steps: losses equal {l1 == l2}, "
          f"{len(bad)} parameter(s) differ {bad[:5]}", flush=True)
    failed = 0
    for i in range(args.repeats):
        with tempfile.TemporaryDirectory() as tmp:
            try:
                cs._res_train(tmp)
                print(f"resume check {i}: bit-equal", flush=True)
            except RuntimeError as e:
                failed += 1
                print(f"resume check {i}: {e}", flush=True)
    print(f"{failed} of {args.repeats} resume checks failed")
    return 1 if bad or failed or l1 != l2 else 0


if __name__ == "__main__":
    sys.exit(main())
