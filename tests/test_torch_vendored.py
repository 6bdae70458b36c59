"""Drift guard for the host modules genestrip_tpu_torch carries as copies
(it cannot import them: genestrip_tpu/__init__.py imports jax, and the GPU
machine has none). Each copy must equal its genestrip_tpu original after
the one rewrite of the import prefix `genestrip_tpu.` -> `genestrip_tpu_torch.`.

The host halves of store/table.py and store/hash.py are held by behaviour
in tests/test_torch_hash.py instead.
"""

from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

COPIES = [
    "utils/dna.py",
    "io/streams.py",
    "io/bgzf.py",
    "io/reads.py",
    "tax/tree.py",
    "tax/small.py",
    "match/results.py",
    "report/java_format.py",
    "report/reporter.py",
    "config.py",
    "project.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    original = (REPO / "genestrip_tpu" / rel).read_text()
    copy = (REPO / "genestrip_tpu_torch" / rel).read_text()
    assert copy == original.replace("genestrip_tpu.", "genestrip_tpu_torch.")
