"""The reference's streaming example in the port —
``repro_torch.examples.bigdata_clustering`` — held to
``examples/bigdata_clustering.py`` on the CPU: in process on the
reference's rows under the jax-replay backend (see
``test_torch_examples.py``), and under ``--topology host_mesh`` as ranks
of each package's ``launch_local``.
"""
import sys

import numpy as np
import pytest

from repro.engine import hostmesh as jhostmesh
from repro_torch.engine import hostmesh as phostmesh
from repro_torch.examples import bigdata_clustering as pbig
from test_torch_examples import (
    ROOT, RTOL, masked, printed_close, run_port, run_reference,
)

CI_ARGV = ["--chunks", "24", "--s", "2048"]


@pytest.mark.parametrize("argv", [
    CI_ARGV, [*CI_ARGV, "--topology", "stream_mesh"],
    ["--chunks", "60", "--s", "2048"]],
    ids=["auto", "stream_mesh", "auto-60-chunks"])
def test_bigdata_clustering_matches_the_reference(argv, monkeypatch, capsys,
                                                  tmp_path):
    """The reference CI's ``--chunks 24 --s 2048``, with the default
    topology and ``stream_mesh``, and at 60 chunks, where the resumed run
    logs a trace entry (at 24 the trace is empty in both): phase 1's and
    the resumed phase 2's chunks and accepts equal; the resumed trace
    entry by entry (chunk ids equal, values within RTOL); the final
    pass's cluster sizes equal and its per-point f within RTOL; every
    printed line word for word but its decimal numbers and walls."""
    want, fits, evals = run_reference(monkeypatch, capsys,
                                      "bigdata_clustering", argv,
                                      tmp_path / "ref")
    got_out, got = run_port(monkeypatch, capsys, pbig, argv,
                            tmp_path / "port")
    (j1, j2), ((jids, jf),) = fits, evals
    r1, r2 = got["phase1"], got["phase2"]
    half = int(argv[1]) // 2
    assert (r1.n_chunks, r2.n_chunks) == (j1.n_chunks, j2.n_chunks) == \
        (half, half)
    assert (r1.n_accepted, r2.n_accepted) == (j1.n_accepted, j2.n_accepted)
    assert r1.objective == pytest.approx(j1.objective, rel=RTOL)
    assert r2.objective == pytest.approx(j2.objective, rel=RTOL)
    assert r2.extras["checkpoint"]["restore_ms"]
    assert len(r2.trace) == len(j2.trace) == (argv[1] == "60")
    for entry, jentry in zip(r2.trace, j2.trace):
        assert entry[0] == jentry[0]
        assert entry[1:] == pytest.approx(jentry[1:], rel=RTOL)
    n_sample = 1_000_000 // 2048
    assert got["sample_rows"] == n_sample * 2048 == len(jids)
    np.testing.assert_array_equal(
        got["sizes"], np.bincount(np.asarray(jids), minlength=25))
    assert got["per_point"] == pytest.approx(float(jf) / len(jids),
                                             rel=RTOL)
    assert len(got_out) == len(want)
    for line_got, line_want in zip(got_out, want):
        assert printed_close(line_got, line_want), (line_got, line_want)
    assert r2.extras["fit"]["device"] == "cpu"


# ------------------------------------------------ host_mesh

# A port rank on the reference's rows under the jax-replay backend, as the
# in-process test runs it.
PORT_RANK = """\
import functools, sys
sys.path.insert(0, {tests!r})
from repro_torch.api import fit
from repro_torch.examples import bigdata_clustering as ex
from test_torch_examples import REPLAY, reference_chunk
ex.gmm_chunk = reference_chunk
ex.fit = functools.partial(fit, rng=REPLAY)
ex.main(sys.argv[1:])
"""


@pytest.mark.parametrize("ranks", [1, 2])
def test_bigdata_clustering_host_mesh_as_the_reference(ranks, tmp_path):
    """``--chunks 24 --s 2048 --topology host_mesh`` as ranks of each
    package's ``launch_local``, each package's ranks on a temp directory
    of their own.  What the reference's example does there: with two
    ranks every rank refuses in phase 1 (the example's ``batch`` of 1 is
    not divisible by 2 hosts) with a ``ValueError`` and exit 1; with one
    rank it runs to the end and prints its single-process lines.  The
    port's ranks do the same: the same first line and last line of a
    refusal, and no checkpoint written; the one rank's lines as the
    reference rank's (``printed_close``: numbers within RTOL)."""
    argv = [*CI_ARGV, "--topology", "host_mesh"]
    outs = {}
    for name, launch, cmd in (
            ("ref", jhostmesh.launch_local,
             [sys.executable, str(ROOT / "examples" /
                                  "bigdata_clustering.py"), *argv]),
            ("port", phostmesh.launch_local,
             [sys.executable, "-c",
              PORT_RANK.format(tests=str(ROOT / "tests")), *argv,
              "--device", "cpu"])):
        tmp = tmp_path / name
        tmp.mkdir()
        env = {"TMPDIR": str(tmp), "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": str(ROOT / "src")}
        procs = launch(cmd, ranks, timeout_s=240, env_extra=env)
        outs[name] = procs
        ckpt = tmp / "bigmeans_demo_ckpt"
        steps = sorted(p.name for p in ckpt.iterdir()) \
            if ckpt.exists() else []
        if ranks == 2:
            assert not any(s.startswith("step_") for s in steps), steps
    for ref, port in zip(outs["ref"], outs["port"]):
        want, got = ref.output.splitlines(), port.output.splitlines()
        if ranks == 2:
            assert ref.returncode == port.returncode == 1, port.output
            assert want[-1] == got[-1] == (
                "ValueError: host_mesh needs hosts (2) to divide the "
                "global batch (1)")
            assert want[0] == got[0] == \
                "phase 1: clustering 12 chunks, then 'crashing'…"
        else:
            assert ref.returncode == port.returncode == 0, port.output
            assert len(got) == len(want) == 7, port.output
            for line_got, line_want in zip(got, want):
                assert printed_close(line_got, line_want), \
                    (line_got, line_want)
            assert masked(got[3]).startswith(
                "  f_best=<f>  accepted=") and "(resumed)" in got[3]
