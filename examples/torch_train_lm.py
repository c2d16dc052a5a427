"""Train a small LM end to end on the PyTorch port with the whole
substrate (checkpointing, restart, the deterministic pipeline), a mid-run
chaos drill included (the counterpart of ``examples/train_lm.py``):
qwen3-0.6b's smoke config on the CUDA card; ``--device cpu`` runs it on
the CPU.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = ap.parse_args(argv).device
    with tempfile.TemporaryDirectory() as d:
        return train_main([
            "--arch", "qwen3-0.6b", "--steps", "60", "--batch", "8",
            "--seq-len", "64", "--ckpt-dir", d, "--ckpt-every", "20",
            "--fail-at", "35",   # chaos drill: injected failure + restart
            "--device", device])


if __name__ == "__main__":
    main()
