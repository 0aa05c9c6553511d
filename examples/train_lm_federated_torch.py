"""End-to-end driver of the PyTorch/CUDA port: federated-train a causal LM
with FLUDE (paper kind: training).  Defaults to a quick 6M-parameter run
on the CUDA card; ``--scale 100m`` for the ~150M-parameter configuration,
``--device cpu`` for the CPU.

    PYTHONPATH=src python examples/train_lm_federated_torch.py --rounds 200
    PYTHONPATH=src python examples/train_lm_federated_torch.py \\
        --scale 100m --rounds 300
    PYTHONPATH=src python examples/train_lm_federated_torch.py \\
        --device cpu --rounds 3
"""
import sys

from repro_torch.launch import train


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--rounds" not in argv:
        argv += ["--rounds", "100"]
    return train.main(argv)


if __name__ == "__main__":
    main()
