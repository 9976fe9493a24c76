"""Disaggregated Prefill-Decode (§5.1): prefill and decode task executors
joined by DistFlow."""
from repro_torch.core.pd_disagg import (REMOTE_SEED_COST, DecodeTE,
                                        DisaggregatedPD, PrefillTE)

__all__ = ["REMOTE_SEED_COST", "DecodeTE", "DisaggregatedPD", "PrefillTE"]
