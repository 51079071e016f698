"""Batched serving example: prefill → decode over any assigned architecture.

    PYTHONPATH=src python examples/torch/serve_model.py --arch mamba2-1.3b
    PYTHONPATH=src python examples/torch/serve_model.py --arch gemma3-12b --gen 48
    PYTHONPATH=src python examples/torch/serve_model.py --arch mamba2-1.3b --device cpu

The counterpart of examples/serve_model.py: its arguments go to
``repro_torch.launch.serve``'s CLI (reduced configs unless ``--full``;
``--device`` defaults to cuda, which raises without a GPU).  On the card a
prefill runs the flash-attention and SSD-scan kernels.
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
