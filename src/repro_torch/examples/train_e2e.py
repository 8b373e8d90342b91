"""End-to-end driver: train a qwen-family model for a few hundred steps on
one device, with checkpointing and auto-resume.

  PYTHONPATH=src python -m repro_torch.examples.train_e2e [--steps 300] \\
      [--device cpu]

Twin of the reference's ``examples/train_e2e.py``, through
``repro_torch.launch.train.main`` with the reference's arguments plus
``--device`` (default cuda).  The model is
qwen1.5-0.5b's ``--smoke`` config (``models.config.smoke_config``: 2
layers, d_model 128, vocab 512), as the reference's script trains.
"""
import argparse
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_e2e")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_e2e_")
    print(f"checkpoints -> {ckpt}")

    loss = train_mod.main([
        "--arch", "qwen1.5-0.5b", "--smoke",
        "--steps", str(args.steps),
        "--global-batch", "8", "--seq-len", "128",
        "--ckpt-dir", ckpt, "--ckpt-every", "100",
        "--log-every", "20", "--device", args.device,
    ])
    print(f"final loss: {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
