"""Serve a small LM with continuous batching on the PyTorch port (the
counterpart of ``examples/serve_lm.py``): gemma3-1b's smoke config, its
weights drawn from a seed, on the CUDA card; ``--device cpu`` runs it on
the CPU.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = ap.parse_args(argv).device
    return serve_main(["--arch", "gemma3-1b", "--requests", "10",
                       "--max-new", "8", "--max-batch", "4",
                       "--device", device])


if __name__ == "__main__":
    main()
