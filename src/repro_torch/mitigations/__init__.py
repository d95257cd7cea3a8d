"""Mitigation lab: pluggable reliability policies + scale-sweep harness.

The measurement half of the repo (cluster sim, ETTR/MTTF models) answers
"how reliable is this cluster?"; this package closes the paper's §IV loop
and answers "what if we intervened?" — checkpoint cadence, lemon eviction,
health-gated scheduling, warm spares, pre-emptive restarts — swept over
policy x scale x seed grids against the analytical ``ettr_model`` bands.
"""
from repro_torch.mitigations.policy import (HOLD, MitigationPolicy,
                                            available_policies, make_policy,
                                            register_policy)

__all__ = [
    "HOLD",
    "MitigationPolicy",
    "available_policies",
    "make_policy",
    "register_policy",
]
