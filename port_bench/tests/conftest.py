"""The benchmark's own tests run on the CPU at toy sizes; those that need a
CUDA card carry the ``card`` marker and take the ``card`` fixture, which
skips them here.  Run them on a card with
``python3 -m pytest port_bench/tests -m card -n 0``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Toy sizes of every cell: a graph of the configuration's shape and levels,
# and batches to match.
TOY_GRAPH = {"num_users": 300, "num_items": 200, "num_ratings": 12000}
TOY_CFG = {"TRAIN": {"RATING_BATCH_SIZE": 1000,
                     "RECON_BATCH_SIZE": 100000}}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOY_TRAFFIC = {"steps_per_call": 10}


def toy_overrides(config_doc):
    """``{graph_override, cfg_override, traffic_override}`` of a cell at
    toy size, on the backend the configuration runs at its own size."""
    return {"graph_override": TOY_GRAPH,
            "cfg_override": dict(TOY_CFG, KERNEL={
                "BACKEND": config_doc["expect_backend"]}),
            "traffic_override": TOY_TRAFFIC}
