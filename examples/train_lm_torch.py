"""End-to-end LM training driver with the CMLS counting plane (PyTorch port).

Thin entrypoint over repro_torch.launch.train: trains a decoder LM on the
calibrated Zipf corpus while a Count-Min-Log sketch counts the token
stream (unigrams + bigrams) in the same pipeline -- the paper's workload
fused into training.  Checkpoints + fault-tolerant loop included.  Runs
on the GPU unless `--device cpu`.

    # CPU-budget run (~25M params, a few hundred steps):
    PYTHONPATH=src python examples/train_lm_torch.py --preset 25m \
        --steps 300 --batch 8 --seq 256 --sketch --ckpt-dir /tmp/lm_ck \
        --device cpu

    # the ~100M-parameter configuration (same code path, sized for an
    # accelerator):
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m \
        --steps 300 --batch 32 --seq 1024 --sketch
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    main(sys.argv[1:])
