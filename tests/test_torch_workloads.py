"""Parity of the port's phased traces (`repro_torch.workloads.traces`) with
the JAX package's: the same phase tables, and the same seed gives the same
(K, B) arrays, dtypes included."""

import numpy as np
import pytest

from repro.workloads import traces as JT
from repro_torch.workloads import traces as TT

TRACES = {**{f"table2_{k}": v for k, v in JT.TABLE2.items()},
          "table3": JT.TABLE3}


def test_phase_tables_are_the_papers():
    assert TT.TABLE2 == JT.TABLE2
    assert TT.TABLE3 == JT.TABLE3
    assert TT.BURSTY_PHASES == JT.BURSTY_PHASES
    assert TT.BURSTY_PHASES_QUICK == JT.BURSTY_PHASES_QUICK


@pytest.mark.parametrize("name", sorted(TRACES))
@pytest.mark.parametrize("steps_per_phase,seed", [(6, 0), (3, 7)])
def test_phased_trace_matches_jax(name, steps_per_phase, seed):
    want = JT.phased_trace(TRACES[name], steps_per_phase=steps_per_phase,
                           seed=seed)
    got = TT.phased_trace(TRACES[name], steps_per_phase=steps_per_phase,
                          seed=seed)
    assert got.seed == want.seed and got.num_steps == want.num_steps
    assert got.width == want.width
    for field in ("ops", "keys", "vals", "num_clients", "init_keys",
                  "init_vals"):
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_phased_trace_with_explicit_width_pads_with_nop():
    want = JT.phased_trace(JT.TABLE2["c_mix"], steps_per_phase=2, width=32,
                           seed=1)
    got = TT.phased_trace(TT.TABLE2["c_mix"], steps_per_phase=2, width=32,
                          seed=1)
    np.testing.assert_array_equal(got.ops, want.ops)
    assert (got.ops[:, 22:] == 2).all()  # OP_NOP lanes past the 22 clients
