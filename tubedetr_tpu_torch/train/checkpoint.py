"""Warm-start surgery on a reference state_dict (counterpart of ``tubedetr_tpu/train/checkpoint.py:warm_start_surgery``).

Saving, loading and resuming the port's own checkpoints come with ROADMAP
queue 1 item 14.
"""

from __future__ import annotations

from typing import Dict


def warm_start_surgery(sd: Dict, num_queries: int) -> Dict:
    """A copy of ``sd`` with ``query_embed.weight`` cut to ``num_queries``
    rows and the sine time-embedding buffer dropped (it is regenerated at
    the model's ``video_max_len``)."""
    sd = dict(sd)
    if "query_embed.weight" in sd and sd["query_embed.weight"].shape[0] > num_queries:
        sd["query_embed.weight"] = sd["query_embed.weight"][:num_queries]
    sd.pop("transformer.time_embed.te", None)
    return sd
