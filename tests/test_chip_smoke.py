"""chip_smoke.py: its guard, its last line, and the comparison code of each
one-card phase, run on the CPU at N=1024 without a security level (the
widths the card runs are a chip_smoke phase, not a test)."""

import json

import jax
import pytest

import chip_smoke
from gemini_seal import CoeffModulus, SecLevelType

SMALL = dict(n=1024, sec=SecLevelType.none, timed=False)


def test_refuses_a_backend_other_than_gpu(monkeypatch):
    def must_not_run():
        raise AssertionError("a phase ran without a GPU")

    monkeypatch.setattr(chip_smoke, "ONE_CARD", (must_not_run,))
    assert jax.default_backend() != "gpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)


def test_last_line_has_exactly_the_contract_keys():
    rec = json.loads(chip_smoke.last_line(jax.devices()[:1]))
    assert rec == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": 1,
    }}


@pytest.mark.parametrize("phase,kwargs", [
    ("ckks_served", dict(batch=6)),
    ("bfv_served", dict(batch=6,
                        coeff=CoeffModulus.create(1024, [40, 40, 40]))),
    ("rotate_many", dict(batch=4, n_steps=3)),
    ("device_evaluator", dict(check=2)),
])
def test_phase_comparisons_pass_on_cpu(phase, kwargs):
    rec = getattr(chip_smoke, phase)(**SMALL, **kwargs)
    assert rec["phase"] == phase
    assert rec["n"] == 1024
    assert any(k.startswith("bit_exact") and v is True
               for k, v in rec.items())
