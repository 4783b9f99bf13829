"""The reference agrees with the port's proofs, and a run whose timed
path is broken, or whose control stands in for the program, comes out
not correct. On the CPU at small sizes: the harness's look for a card is
skipped, the rest of a run is driven as on the card."""

import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.inputs import fibonacci, recursion
from benchmark.reference import proof as pf
from benchmark.reference import stark as ref

SMALL = {
    "fibonacci": dict(air="fibonacci", width=2, num_public_values=3, log_n=6, log_blowup=2, num_queries=3,
                      proof_of_work_bits=4, log_final_poly_len=0),
    "recursion": dict(air="recursion", width=163, num_public_values=12, log_n=5, log_blowup=4, num_queries=2,
                      proof_of_work_bits=4, log_final_poly_len=2),
}
TRAFFIC = {"loop": "closed", "clients": 1, "warmup": 1, "queue_per_second": 1.0}


def _prove(config, count, seed):
    from tapstark_torch.field import F
    from tapstark_torch.stark import prove
    from tapstark_torch.stark.config import standard_config
    from tapstark_torch.stark.serde import proof_to_bytes

    inputs = {"fibonacci": fibonacci, "recursion": recursion}[config["air"]]
    cfg = standard_config(log_blowup=config["log_blowup"], num_queries=config["num_queries"],
                          proof_of_work_bits=config["proof_of_work_bits"], device="cpu",
                          log_final_poly_len=config["log_final_poly_len"])
    out = []
    for trace, pis in inputs.statements(config["log_n"], count, np.random.default_rng(seed), "cpu"):
        out.append((trace, pis, proof_to_bytes(prove(cfg.pcs, inputs.port_air(), cfg.challenger(), trace,
                                                     [F(v) for v in pis]))))
    return out


@pytest.mark.parametrize("air", sorted(SMALL))
def test_the_reference_agrees_with_the_ports_proofs(air, monkeypatch):
    config = SMALL[air]
    s = ref.Setting.from_config(config)
    monkeypatch.setattr(ref, "TREES_PER_COMMIT", config["num_queries"])  # every tree rebuilt
    for job, (trace, pis, data) in enumerate(_prove(config, 2, 2**31 + 11)):
        assert pf.serialize(pf.parse(data)) == data
        result = ref.check(s, trace, pis, data, prior_proves=job, sample_seed=job, device="cpu")
        assert result and not any(result.values()), result
        # the same proof credited to another place in the stream has other keys
        wrong = ref.check(s, trace, pis, data, prior_proves=job + 1, sample_seed=job, device="cpu")
        assert wrong["query_keys"] > 0 and wrong["bytes"] == 1


def test_a_changed_byte_is_found():
    config = SMALL["fibonacci"]
    (trace, pis, data), = _prove(config, 1, 7)
    s = ref.Setting.from_config(config)
    for pos in (20, len(data) // 3, len(data) - 5):
        bad = bytearray(data)
        bad[pos] ^= 0x01
        result = ref.check(s, trace, pis, bytes(bad), prior_proves=0, sample_seed=1, device="cpu")
        assert any(result.values()), pos


def _run(air, seed, control=None):
    t = time.perf_counter()
    return harness.run(f"{air}.cell", {"chips": 1}, SMALL[air], TRAFFIC, seed, 2.0, False, "cpu",
                       {"end_to_end": [{"name": "prove_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}],
                        "per_layer": []}, t, control)


@pytest.mark.parametrize("air", sorted(SMALL))
def test_a_run_is_correct(air):
    line = _run(air, 2**31 + 99)
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks" and line["checks"]["proofs_checked"]["value"] == 1
    assert set(line["metrics"]) == {"prove_s", "setup_s"}


def test_the_control_is_not_correct():
    """The control breaks the configuration's 28 (here 3) query
    repetitions: one fewer, the cut that would make a prove cheaper."""
    line = _run("fibonacci", 2**31 + 5, control="queries-1")
    assert not line["correct"]
    assert line["checks"]["bytes"]["value"] == 1 and line["checks"]["roots"]["value"] > 0


def _root_word_altered(monkeypatch):
    from tapstark_torch.commit.tcs import SparseNativeTaptree

    words = SparseNativeTaptree.root_words

    def altered(self):
        out = words(self)
        out[0] ^= 1
        return out

    monkeypatch.setattr(SparseNativeTaptree, "root_words", altered)


def _lde_word_altered(monkeypatch):
    import tapstark_torch.fri.pcs as pcs

    lde = pcs.coset_lde_batch_auto

    def altered(evals, log_blowup, shift):
        out = lde(evals, log_blowup, shift).clone()
        out[3, 0] = (out[3, 0] + 1) % (2**31 - 2**27 + 1)
        return out

    monkeypatch.setattr(pcs, "coset_lde_batch_auto", altered)


def _keys_state_unchanged(monkeypatch):
    from tapstark_torch.commit.bitcomm import BcManager

    assign = BcManager.assign_bcs

    def unchanged(self, commit_type, count):
        counter = self._counter
        out = assign(self, commit_type, count)
        self._counter = counter
        return out

    monkeypatch.setattr(BcManager, "assign_bcs", unchanged)


def _half_the_quotient_rows(monkeypatch):
    import tapstark_torch.stark.prover as prover

    quotient = prover.quotient_values

    def half(*args):
        out = quotient(*args).clone()
        out[out.shape[0] // 2 :] = 0
        return out

    monkeypatch.setattr(prover, "quotient_values", half)


@pytest.mark.parametrize("fault", [_root_word_altered, _lde_word_altered, _keys_state_unchanged,
                                   _half_the_quotient_rows])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """An answer altered where it is produced (a taptree root's word; one
    LDE word, which the prover's own low-degree check stops: the proofs
    never come, and count as failed); a step that
    returns its state unchanged (the bit-commitment manager's counter);
    half of the batch left out (the quotient's second half of rows). A
    one-card cell has no exchange between cards to leave out."""
    fault(monkeypatch)
    line = _run("fibonacci", 2**31 + 21)
    assert not line["correct"], line["checks"]
