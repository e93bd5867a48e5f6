"""The reference's public-API examples in the port —
``repro_torch.examples.quickstart`` and ``serve_assignments`` — held to
``examples/quickstart.py`` and ``examples/serve_assignments.py`` on the
CPU at the reference CI's sizes (``.github/workflows/ci.yml``).

Both examples run on the reference's own rows: the port module's
generator is patched to hand it ``repro.data.synthetic``'s rows as numpy
(the two packages' generators draw other rows), and its ``fit`` runs under
the jax-replay backend, so the two take the same decisions.  The helpers
here are shared with ``test_torch_examples_stream.py``.
"""
import functools
import importlib.util
import re
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.api import evaluate as pevaluate
from repro_torch.api import fit as pfit
from repro_torch.examples import quickstart as pquick
from repro_torch.examples import serve_assignments as pserve
from repro_torch.kernels import ops as pops
from repro_torch.serve import registry as pregistry
from repro_torch.serve import server as pserver
from test_torch_cuda import d_bound
from test_torch_rng import REPLAY

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5       # f32 objectives summed in another order
FLOAT = re.compile(r"\d+\.\d+(?:e[-+]\d+)?")
WALL = re.compile(r"wall=\d+\.\d+s")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The products here are small: two torch threads keep the suite's
    parallel workers from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def reference_example(name: str):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capturing(fn, seen: list):
    """``fn`` with each call's result appended to ``seen``."""
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        seen.append(out)
        return out
    return wrapper


def reference_chunk(spec, chunk_id, size, *, device):
    """The reference's ``gmm_chunk`` rows for the port's spec, as numpy."""
    jspec = jsyn.GMMSpec(**spec._asdict())
    return np.asarray(jsyn.gmm_chunk(jspec, chunk_id, size))


def reference_dataset(spec, *, device):
    return np.asarray(jsyn.gmm_dataset(jsyn.GMMSpec(**spec._asdict())))


def on_reference_rows(monkeypatch, module) -> None:
    """The port example's generator on the reference's rows, its ``fit``
    under the jax-replay backend."""
    for name, rows in (("gmm_chunk", reference_chunk),
                       ("gmm_dataset", reference_dataset)):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, rows)
    monkeypatch.setattr(module, "fit", functools.partial(pfit, rng=REPLAY))


def run_reference(monkeypatch, capsys, name: str, argv: list, tmp: Path):
    """The reference example's ``main()`` under ``argv`` with its temp
    directory at ``tmp``: (printed lines, its fit results, its evaluate
    results)."""
    mod = reference_example(name)
    fits, evals = [], []
    mod.fit = capturing(mod.fit, fits)
    if hasattr(mod, "evaluate"):
        mod.evaluate = capturing(mod.evaluate, evals)
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    return capsys.readouterr().out.splitlines(), fits, evals


def run_port(monkeypatch, capsys, module, argv: list, tmp: Path):
    """The port example's ``main([*argv, "--device", "cpu"])`` on the
    reference's rows under the jax-replay backend, its temp directory at
    ``tmp``: (printed lines, what it returned)."""
    on_reference_rows(monkeypatch, module)
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp))
    got = module.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out.splitlines(), got


def masked(line: str) -> str:
    """A printed line with its walls and decimal numbers masked: the text
    and every integer in it stay."""
    return FLOAT.sub("<f>", WALL.sub("wall=<s>", line))


def printed_close(got: str, want: str, rtol: float = RTOL) -> bool:
    """Two printed lines equal but for their decimal numbers (walls
    masked), each number within ``rtol`` of the reference's plus one unit
    of its last printed digit."""
    if masked(got) != masked(want):
        return False
    got, want = WALL.sub("", got), WALL.sub("", want)
    for a, b in zip(FLOAT.findall(got), FLOAT.findall(want)):
        mant, _, exp = b.partition("e")
        unit = 10.0 ** (int(exp or 0) - len(mant.split(".")[1]))
        if abs(float(a) - float(b)) > rtol * abs(float(b)) + unit:
            return False
    return True


# ------------------------------------------------ quickstart

QUICK_ARGV = ["--m", "20000", "--chunks", "8"]


def test_quickstart_matches_the_reference(monkeypatch, capsys, tmp_path):
    """``--m 20000 --chunks 8``: the dataset, strategy and distance lines
    word for word; chunks, accepts and the K-means++ baseline's Lloyd
    iterations equal; both full-data objectives within RTOL."""
    want, fits, evals = run_reference(monkeypatch, capsys, "quickstart",
                                      QUICK_ARGV, tmp_path / "ref")
    got_out, got = run_port(monkeypatch, capsys, pquick, QUICK_ARGV,
                            tmp_path / "port")
    (jres, jbase), ((_, jf),) = fits, evals
    res, base = got["result"], got["baseline"]
    assert len(got_out) == len(want) == 5
    assert got_out[:3] == want[:3]
    assert want[0] == "dataset: (20000, 16),  k=12,  chunk size s=4000"
    assert res.strategy == jres.strategy == "sequential"
    assert (res.n_chunks, res.n_accepted) == (jres.n_chunks, jres.n_accepted)
    assert res.n_dist_evals == jres.n_dist_evals
    assert got["objective"] == pytest.approx(float(jf), rel=RTOL)
    assert base.n_iterations == jbase.n_iterations
    assert got["baseline_iterations"] == base.n_iterations
    assert base.objective == pytest.approx(jbase.objective, rel=RTOL)
    for line_got, line_want in zip(got_out[3:], want[3:]):
        assert printed_close(line_got, line_want)
    assert res.extras["fit"]["device"] == "cpu"
    assert tuple(got["ids"].shape) == (20000,)


# ------------------------------------------------ serving + hot-swap

SERVE_ARGV = ["--chunks", "24", "--clients", "4", "--requests", "30"]
# At 12 chunks the retrain accepts a chunk in both packages, so its last
# checkpoint holds other centroids than the trained fit's.
SERVE_SWAP_ARGV = ["--chunks", "12", "--clients", "4", "--requests", "30"]
SWAP_WAIT_S = 120     # the longest a held request waits for the last swap


def serve_against_reference(monkeypatch, capsys, tmp_path, argv: list,
                            hold: bool = False):
    """Both packages' serving example under ``argv``, the port's responses
    and swaps recorded by wrapping ``Server.assign`` and
    ``ModelEntry.swap``.  The trained and retrained ``summary()`` as the
    reference's (f within RTOL, the rest word for word but the wall);
    every request completes; each response's ids are those that
    ``evaluate`` gives on its rows for the centroids of the version it
    reports (version 0: the trained fit's; version v: the v-th swap's,
    recorded as it is made), and its distances the plain version's there
    within ``d_bound`` (RTOL of the terms' magnitude); no capture after
    warmup.

    With ``hold``, the second half of each client's requests wait (up to
    SWAP_WAIT_S) until the watcher has swapped in the retrain's last
    checkpoint, so that they are served by it whatever the timing.
    Returns (the port's result, the reference's fits, {version:
    centroids}, [(rows, response)])."""
    want, fits, _ = run_reference(monkeypatch, capsys, "serve_assignments",
                                  argv, tmp_path / "ref")
    responses, snapshots, watchers = [], {}, []
    lock, sent = threading.Lock(), threading.local()
    assign, swap = pserver.Server.assign, pregistry.ModelEntry.swap
    watch = pserver.Server.watch
    chunks, clients, requests = (int(argv[argv.index(f) + 1]) for f in
                                 ("--chunks", "--clients", "--requests"))

    def recording_watch(self, *args, **kw):
        watcher = watch(self, *args, **kw)
        watchers.append(watcher)
        return watcher

    def recording_assign(self, model_id, points, *args, **kw):
        sent.n = getattr(sent, "n", 0) + 1       # this client's requests
        if hold and sent.n > requests // 2:
            deadline = time.monotonic() + SWAP_WAIT_S
            while (watchers[0].last_step != 2 * chunks
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        resp = assign(self, model_id, points, *args, **kw)
        with lock:
            responses.append((np.array(points), resp))
        return resp

    def recording_swap(self, centroids, **kw):
        snap = swap(self, centroids, **kw)
        with lock:
            snapshots[snap.version] = snap.centroids.clone()
        return snap

    monkeypatch.setattr(pserver.Server, "watch", recording_watch)
    monkeypatch.setattr(pserver.Server, "assign", recording_assign)
    monkeypatch.setattr(pregistry.ModelEntry, "swap", recording_swap)
    got_out, got = run_port(monkeypatch, capsys, pserve, argv,
                            tmp_path / "port")
    (jtrained, jmore) = fits
    for res, jres, i in ((got["trained"], jtrained, 0),
                         (got["retrained"], jmore, 1)):
        assert res.objective == pytest.approx(jres.objective, rel=RTOL)
        assert (res.n_chunks, res.n_accepted, res.n_iterations) == \
            (jres.n_chunks, jres.n_accepted, jres.n_iterations)
        assert printed_close(got_out[i], want[i])
    n = clients * requests
    assert got["completed"] == n == len(responses)
    assert got["stats"]["n_requests"] == n
    assert got["recompiles_after_warmup"] == 0
    assert got_out[3] == want[3] == \
        "recompiles after warmup: 0 (buckets: (64, 128, 256, 512, 1024))"
    assert got_out[-1].startswith(f"all {n} client requests completed; ")
    assert want[-1].startswith(f"all {n} client requests completed; ")
    snapshots[0] = got["trained"].centroids
    for points, resp in responses:
        assert 32 <= len(points) < 256 and resp.model_id == "gmm"
        c = snapshots[resp.version]
        ids, _ = pevaluate(c, points, device="cpu")
        np.testing.assert_array_equal(resp.ids, ids.numpy())
        _, d = pops.assign(torch.from_numpy(points), c, impl="ref")
        assert np.all(np.abs(resp.dists - d.numpy())
                      <= d_bound(points, c.numpy(), resp.ids))
    assert sorted({resp.version for _, resp in responses}) == got["versions"]
    assert [t[2] for t in got["trace"]] == sorted(t[2] for t in got["trace"])
    return got, fits, snapshots, responses


def test_serve_assignments_matches_the_reference(monkeypatch, capsys,
                                                 tmp_path):
    """``--chunks 24 --clients 4 --requests 30``, the reference CI's size,
    held as :func:`serve_against_reference` says.  (At this size the
    retrain accepts nothing, in both packages, so every version holds the
    trained centroids: ``test_serve_assignments_swaps_in_the_retrain``
    serves a swap that changes them.)  When the watcher swaps, how the
    batcher packs requests and which versions the clients see depend on
    timing: nothing here asserts ``n_swaps``, ``n_batches`` or the
    versions seen."""
    serve_against_reference(monkeypatch, capsys, tmp_path, SERVE_ARGV)


def test_serve_assignments_swaps_in_the_retrain(monkeypatch, capsys,
                                                tmp_path):
    """``--chunks 12``: the retrain accepts a chunk (in both packages), so
    the watcher's swap of its last checkpoint changes the centroids; the
    second half of each client's requests wait for that swap, so they are
    served by a version whose centroids differ from the trained fit's, and
    their ids and distances are that version's.  (The mixture is well
    separated: the retrain moves the centroids without moving an id on
    these rows, so the distances are what tell the versions apart.)  Only what
    the hold makes certain is asserted: not ``n_swaps``, ``n_batches`` or
    which other versions the clients see."""
    got, fits, snapshots, responses = serve_against_reference(
        monkeypatch, capsys, tmp_path, SERVE_SWAP_ARGV, hold=True)
    assert fits[1].n_accepted >= 1
    changed = {v for v, c in snapshots.items()
               if not torch.equal(c, snapshots[0])}
    assert changed
    assert sum(resp.version in changed for _, resp in responses) >= 4 * 15


def test_example_lines_are_the_reference_formats():
    """The printed formats: a line of each example read back through the
    helpers' masks (a self-check of ``masked`` / ``printed_close``)."""
    line = "  f_best=5.59932e+04  accepted=1  wall=2.2s"
    assert masked(line) == "  f_best=<f>  accepted=1  wall=<s>"
    assert printed_close("  f_best=5.59933e+04  accepted=1  wall=9.0s", line)
    assert not printed_close("  f_best=5.59960e+04  accepted=1  wall=2.2s",
                             line)
    assert not printed_close("  f_best=5.59932e+04  accepted=2  wall=2.2s",
                             line)
