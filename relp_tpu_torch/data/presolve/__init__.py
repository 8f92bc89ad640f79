"""Presolve — queue-driven fixpoint simplification.

Mirror of reference ``general_form/presolve``: four rules (fixed-variable
substitution, singleton-constraint bounds, slack elimination, domain
propagation) driven by dedup queues over row/column nonzero counters, emitting
a batch of `Changes` applied to the GeneralForm afterwards.

The engine lives in :mod:`relp_tpu_torch.data.presolve.index`; rules in
:mod:`relp_tpu_torch.data.presolve.rules`.
"""

from relp_tpu_torch.data.presolve.index import presolve

__all__ = ["presolve"]
