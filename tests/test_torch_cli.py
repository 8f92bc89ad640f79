"""`python -m relp_tpu_torch` against `python -m relp_tpu`, on in-repo data."""

import json
import os

import pytest

from relp_tpu.__main__ import main as jax_main
from relp_tpu_torch.__main__ import main
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)

KNAP6 = os.path.join(os.path.dirname(__file__), "data", "knap6.mps")
EXACT_FIELDS = ("status", "objective", "objective_float", "certified",
                "iterations", "phase1_iterations")


def _run(cli, argv, capsys):
    rc = cli(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_cli_json_payload_matches_jax(capsys):
    rc_j, jax_out = _run(jax_main, ["solve", "--json", "--values", KNAP6], capsys)
    rc, out = _run(
        main, ["solve", "--json", "--values", "--platform", "cpu", KNAP6], capsys
    )
    assert rc == rc_j == 0
    assert set(out) == set(jax_out)
    assert {k: out[k] for k in EXACT_FIELDS} == {k: jax_out[k] for k in EXACT_FIELDS}
    assert out["values"] == jax_out["values"]
    assert out["objective"] == "-30" and out["certified"] is True


def test_cli_certificate_round_trip(tmp_path, capsys):
    cert = str(tmp_path / "knap6.cert.json")
    basis = str(tmp_path / "knap6.basis.json")
    rc = main(["solve", "--platform", "cpu", "--certificate", cert,
               "--save-basis", basis, KNAP6])
    assert rc == 0 and os.path.exists(cert) and os.path.exists(basis)
    capsys.readouterr()
    assert main(["verify", KNAP6, cert]) == 0
    assert capsys.readouterr().out.startswith("VERIFIED")
    # The JAX package's verifier accepts the port's certificate too.
    assert jax_main(["verify", KNAP6, cert]) == 0
    assert capsys.readouterr().out.startswith("VERIFIED")


# The timing field of the LP payloads; the MIP payload has none.
TIMING = ("wall_time_s",)


@pytest.mark.parametrize("mode", [["--mip", "--values"], ["--first-order", "--values"],
                                  ["--basis-inverse", "lu", "--values"],
                                  ["--mip", "--gap", "0.5", "--branching",
                                   "most_fractional", "--cut-rounds", "1"]])
def test_cli_solve_modes_match_jax(mode, capsys):
    """--mip, --first-order and --basis-inverse lu: the JAX CLI's --json
    payload and exit code, timing aside."""
    rc_j, jax_out = _run(jax_main, ["solve", "--json", *mode, KNAP6], capsys)
    rc, out = _run(main, ["solve", "--json", "--platform", "cpu", *mode, KNAP6], capsys)
    assert rc == rc_j == 0
    drop = lambda d: {k: v for k, v in d.items() if k not in TIMING}  # noqa: E731
    assert drop(out) == drop(jax_out)
    assert out["objective"] == "-30" and out["certified"] is True


def test_cli_mip_certificate_notice(tmp_path, capsys):
    """--certificate with --mip writes nothing and says why, as the JAX CLI."""
    cert = str(tmp_path / "knap6.cert.json")
    rc = main(["solve", "--mip", "--platform", "cpu", "--certificate", cert, KNAP6])
    err = capsys.readouterr().err
    assert rc == 0 and not os.path.exists(cert)
    assert "applies to LP solves only" in err
