"""Model tables of the exact ("fast") vote engine.

Port of the part of ``objective_slam_tpu.ops.voting_fast`` that the main
path needs (voting_fast.py:159-232): ``FastModelTables`` carrying the
block-expansion tables. The legacy fast engine — the fallback for models
over the block budgets, whose tally is TPU kernel K2
(``voting_fast._pallas_tally``) — is not ported yet, so such a model
raises instead of falling back silently.
"""

from __future__ import annotations

from typing import NamedTuple

from objective_slam_tpu_torch.ops import voting as voting_ref
from objective_slam_tpu_torch.ops import voting_block


class FastModelTables(NamedTuple):
    """Model-side tables of engine="fast": the block-expansion tables."""
    block: voting_block.BlockTables


def build_fast_tables(table: voting_ref.KeyTable) -> FastModelTables:
    block = voting_block.build_block_tables(table)
    if block is None:
        raise NotImplementedError(
            "model exceeds the block engine's budgets (n_model < 1024, "
            f"occupied keys <= {voting_block.BLOCK_MAX_KOCC}); its fallback "
            "engine and tally kernel K2 are not ported yet (ROADMAP queue 1 "
            "item 11, queue 2 K2)")
    return FastModelTables(block=block)
