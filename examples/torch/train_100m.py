"""End-to-end training on PyTorch: ~100M-parameter model, real loop.

The counterpart of ``examples/train_100m.py``: the port's production
trainer (data pipeline -> train step -> async checkpoints -> resume,
:mod:`repro_torch.launch.train`) on a scaled-down glm4-family config, on
the card (the flash kernel in the forward) unless ``--device cpu``.

    PYTHONPATH=src python examples/torch/train_100m.py [--steps 300]
    PYTHONPATH=src python examples/torch/train_100m.py --device cpu --steps 20

Any assigned architecture works: ``--arch mixtral-8x7b`` trains the scaled
MoE variant, ``--arch mamba2-780m`` the SSD variant, etc.  Checkpoints go
to a fresh temporary directory unless ``--ckpt-dir`` names one.
"""
import argparse
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        out = train.main([
            "--arch", args.arch, "--preset", "p100m",
            "--steps", str(args.steps), "--batch", str(args.batch),
            "--seq", str(args.seq), "--ckpt-dir", args.ckpt_dir or tmp,
            "--ckpt-every", "50", "--resume", "--device", args.device,
        ])
    print(f"first loss {out['first_loss']:.4f} -> last loss {out['last_loss']:.4f}")
    assert out["last_loss"] < out["first_loss"], "loss did not improve"
    return out


if __name__ == "__main__":
    main()
