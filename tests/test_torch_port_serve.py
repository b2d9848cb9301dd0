"""The port's turn server (``theatergen_tpu_torch/serve.py``) on the CPU:
the mirror of tests/test_serve.py (the batching queue, the wave policies,
backpressure, sessions and their resume, failure isolation, close and the
HTTP facade) over the port's tiny bundle; its mesh test is
``test_torch_port_mesh_cli.py``'s (the server over two ranks).  Images of a wave match the serial turns' within
BATCH_TOL; a resumed or rerun turn equals the uninterrupted one bit for
bit (the port's draws are the seed's alone)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from theatergen_tpu_torch.config import tiny_config
from theatergen_tpu_torch.pipelines.bundle import init_bundle
from theatergen_tpu_torch.serve import ServerBusy, TheaterServer, serve_http

torch.set_num_threads(1)

# a wave against the serial turns: the batch changes the UNet's summation
# order only (fp32)
BATCH_TOL = 2e-4

SPEC_A = {
    "prompt": "a knight in a forest",
    "gen_boxes": [("a red knight", (50, 100, 150, 300))],
    "bg_prompt": "a forest clearing",
    "extra_neg_prompt": "",
    "obj_ids": [0],
    "canvas_height": 512, "canvas_width": 512,
}
SPEC_B = {
    "prompt": "a dragon over mountains",
    "gen_boxes": [("a green dragon", (300, 80, 180, 350))],
    "bg_prompt": "snowy mountains",
    "extra_neg_prompt": "",
    "obj_ids": [0],
    "canvas_height": 512, "canvas_width": 512,
}


@pytest.fixture(scope="module")
def bundle():
    return init_bundle(tiny_config(), 0, device="cpu", with_ip=True,
                       with_controlnet=True, with_vision=True)


@pytest.fixture()
def server(bundle, tmp_path):
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=0.2)
    yield srv
    srv.close()


def test_single_session_turns_sequential(server):
    server.open_session("dlg0")
    r1 = server.run_turn("dlg0", SPEC_A, seed=0, timeout=600)
    assert r1.image.shape[-1] == 3
    assert np.isfinite(r1.image).all()
    # second turn reuses the session's DB (turn index advanced)
    r2 = server.run_turn("dlg0", SPEC_A, seed=1, timeout=600)
    assert server.sessions["dlg0"].turn_index == 2
    assert server.stats()["turns"] == 2
    assert not np.array_equal(r1.image, r2.image)   # different seeds


def test_concurrent_sessions_form_a_wave(server):
    server.open_session("a")
    server.open_session("b")
    # stall the worker with a first request so both land in one window
    f1 = server.submit("a", SPEC_A, seed=0)
    f2 = server.submit("b", SPEC_B, seed=0)
    res = [f1.result(timeout=900), f2.result(timeout=900)]
    assert all(np.isfinite(r.image).all() for r in res)
    # either both were taken into one wave, or timing split them — but
    # with a 0.2 s window and an immediate double submit the wave path
    # must have fired at least for the tail pair in this module's runs
    assert server.stats()["turns"] == 2


def test_wave_matches_serial(bundle, tmp_path):
    """A wave of two dialogues gives the images of running each dialogue
    serially (batching is a layout, not a semantic)."""
    srv = TheaterServer(bundle, str(tmp_path / "db1"), num_steps=3,
                        batch_window_s=0.5)
    try:
        srv.open_session("a")
        srv.open_session("b")
        f1 = srv.submit("a", SPEC_A, seed=3)
        f2 = srv.submit("b", SPEC_B, seed=4)
        wave_a, wave_b = f1.result(900), f2.result(900)
        took_wave = srv.stats()["waves"] >= 1
    finally:
        srv.close()

    srv2 = TheaterServer(bundle, str(tmp_path / "db2"), num_steps=3,
                         batch_window_s=0.0)   # no batching: serial
    try:
        srv2.open_session("a")
        srv2.open_session("b")
        ser_a = srv2.run_turn("a", SPEC_A, seed=3, timeout=900)
        ser_b = srv2.run_turn("b", SPEC_B, seed=4, timeout=900)
        assert srv2.stats()["waves"] == 0
    finally:
        srv2.close()

    assert took_wave
    np.testing.assert_allclose(wave_a.image, ser_a.image, atol=BATCH_TOL)
    np.testing.assert_allclose(wave_b.image, ser_b.image, atol=BATCH_TOL)


def test_server_refuses_a_mesh(bundle, tmp_path):
    """The server runs on a mesh's rank 0: anything else given as
    ``mesh=`` is refused before a thread starts (the mesh itself:
    ``test_torch_port_mesh_cli.py``)."""
    with pytest.raises(ValueError, match="rank 0"):
        TheaterServer(bundle, str(tmp_path / "db"), mesh=object())


def test_same_session_not_batched_in_one_wave(server):
    server.open_session("s")
    f1 = server.submit("s", SPEC_A, seed=0)
    f2 = server.submit("s", SPEC_A, seed=1)
    f1.result(900), f2.result(900)
    # both ran (ordered), never as a wave
    assert server.sessions["s"].turn_index == 2
    assert server.stats()["waves"] == 0


def test_backpressure(bundle, tmp_path):
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        max_queue=1, batch_window_s=0.0)
    try:
        srv.open_session("x")
        srv.open_session("y")
        f1 = srv.submit("x", SPEC_A, seed=0)
        with pytest.raises(ServerBusy):
            srv.submit("y", SPEC_B, seed=0)
            srv.submit("y", SPEC_B, seed=1)
        f1.result(900)
    finally:
        srv.close()


def test_auto_seeds_unique_for_pipelined_submits(server):
    """Auto-derived seeds must differ even when the second turn is
    submitted while the first is still in flight (turn_index hasn't
    advanced yet)."""
    server.open_session("p")
    r1 = server._submit("p", SPEC_A, None)
    r2 = server._submit("p", SPEC_A, None)
    assert r1.seed != r2.seed
    res1, res2 = r1.future.result(900), r2.future.result(900)
    assert not np.array_equal(res1.image, res2.image)
    # turn numbers were assigned atomically with completion
    assert (r1.turn_no, r2.turn_no) == (1, 2)


def test_run_turn_numbered(server):
    server.open_session("n")
    turn, res = server.run_turn_numbered("n", SPEC_A, seed=5, timeout=900)
    assert turn == 1 and np.isfinite(res.image).all()


def test_wave_failure_isolated_per_request(bundle, tmp_path):
    """One malformed spec must not fail its wave-mates: the worker falls
    back to per-request serial runs (mirroring the CLI quarantine), and
    the failed wave leaves no stale deferred DB state behind."""
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=0.5)
    try:
        srv.open_session("good")
        srv.open_session("bad")
        f_good = srv.submit("good", SPEC_A, seed=0)
        bad_spec = dict(SPEC_B)
        del bad_spec["gen_boxes"]
        f_bad = srv.submit("bad", bad_spec, seed=0)
        res = f_good.result(900)       # must succeed despite the wave-mate
        assert np.isfinite(res.image).all()
        with pytest.raises(Exception):
            f_bad.result(900)
        for s in srv.sessions.values():
            assert not s.theater._pending_saves
        # the good session keeps working afterwards
        res2 = srv.run_turn("good", SPEC_A, seed=1, timeout=900)
        assert np.isfinite(res2.image).all()
    finally:
        srv.close()


def test_cancelled_future_does_not_kill_worker(server):
    """cancel() on a queued Future must not crash the worker thread;
    later submits keep working and the cancelled turn never advances the
    session."""
    server.open_session("c1")
    f1 = server.submit("c1", SPEC_A, seed=0)
    f2 = server.submit("c1", SPEC_A, seed=1)   # waits in session FIFO
    assert f2.cancel()
    f1.result(timeout=900)
    # the worker survived: a fresh submit completes
    r3 = server.run_turn("c1", SPEC_A, seed=2, timeout=900)
    assert np.isfinite(r3.image).all()
    assert server.sessions["c1"].turn_index == 2   # cancelled turn skipped


def test_bad_seed_does_not_leak_pending_slot(server):
    server.open_session("b1")
    for _ in range(3):
        with pytest.raises(ValueError, match="seed must be an integer"):
            server.submit("b1", SPEC_A, seed="abc")  # type: ignore[arg-type]
    assert server.stats()["pending"] == 0
    # seed stream unshifted: auto-seeded turn still runs
    assert np.isfinite(server.run_turn("b1", SPEC_A,
                                       timeout=900).image).all()


def test_invalid_session_ids_rejected(server):
    # "abc\n" is a legal JSON string and `$` alone would accept it —
    # fullmatch must reject ids with a trailing newline
    for bad in ("../evil", "/tmp/evil", "a/b", "", ".hidden", "x" * 200,
                "abc\n", "a\nb"):
        with pytest.raises(ValueError, match="invalid session id"):
            server.open_session(bad)


def test_close_session_rejects_mid_open_reservation(server):
    """close_session on an id whose open_session is still constructing
    (None reservation) must refuse — popping the reservation would let a
    concurrent open build a second Theater on the same DB directory."""
    server.sessions["mid"] = None        # simulate in-flight open_session
    try:
        with pytest.raises(RuntimeError, match="still being opened"):
            server.close_session("mid")
    finally:
        server.sessions.pop("mid", None)


def test_close_rearms_stop_for_busy_worker(bundle, tmp_path):
    """close(timeout) expiring while the worker is mid-turn must not eat
    the stop sentinel: the worker has to exit after its wave instead of
    blocking in _queue.get() forever (a leaked thread per server)."""
    import time as _time

    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=0.0)
    srv.open_session("s")
    started = threading.Event()
    orig = srv.sessions["s"].theater.run_turn

    def slow(spec, seed, *a, **k):
        started.set()
        _time.sleep(1.0)
        return orig(spec, seed, *a, **k)

    srv.sessions["s"].theater.run_turn = slow
    f = srv.submit("s", SPEC_A, seed=0)
    assert started.wait(600)          # worker is now inside the turn
    srv.close(timeout=0.05)           # join times out mid-wave
    f.result(timeout=900)             # the in-flight turn still completes
    srv._worker.join(timeout=600)
    assert not srv._worker.is_alive()


def test_close_fails_queued_futures(bundle, tmp_path):
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=0.0)
    srv.open_session("q")
    f1 = srv.submit("q", SPEC_A, seed=0)
    f2 = srv.submit("q", SPEC_A, seed=1)   # in session FIFO behind f1
    srv.close()
    # f1 may have completed or been interrupted; f2 must NOT hang forever
    try:
        f1.result(timeout=900)
    except RuntimeError:
        pass
    with pytest.raises(RuntimeError, match="server closed"):
        f2.result(timeout=60)


def test_wave_prep_error_keeps_fallback_dialogue_result(bundle, tmp_path):
    """Session A's spec has duplicate obj_ids (runs serially inside the
    wave, durable DB writes); session B's spec is malformed and fails in
    host prep.  A's completed result must be delivered (not re-run
    against its mutated DB) and B gets the error."""
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=0.5)
    try:
        srv.open_session("a")
        srv.open_session("b")
        spec_dup = {
            "prompt": "a cat sits beside a sleeping cat",
            "gen_boxes": [("a cat", (50, 100, 120, 120)),
                          ("a sleeping cat", (300, 100, 120, 120))],
            "bg_prompt": "a sunny room", "extra_neg_prompt": "",
            "obj_ids": [7, 7],
            "canvas_height": 512, "canvas_width": 512,
        }
        bad = {k: v for k, v in SPEC_B.items() if k != "gen_boxes"}
        fa = srv.submit("a", spec_dup, seed=0)
        fb = srv.submit("b", bad, seed=0)
        res_a = fa.result(timeout=900)
        assert np.isfinite(res_a.image).all()
        with pytest.raises(Exception):
            fb.result(timeout=900)
        # A ran exactly once (the in-wave serial fallback), no rerun
        assert srv.stats()["turns"] == 1
    finally:
        srv.close()


def test_session_resume_after_restart(bundle, tmp_path):
    """session.json + the character DB make a dialogue resumable across
    server restarts: the resumed turn 2 must equal an uninterrupted
    session's turn 2 (seed counters continue, identity chains via DB)."""
    srv = TheaterServer(bundle, str(tmp_path / "a"), num_steps=3,
                        batch_window_s=0.0)
    try:
        srv.open_session("d")
        srv.run_turn("d", SPEC_A, timeout=900)          # auto seeds
        cont = srv.run_turn("d", SPEC_A, timeout=900)
    finally:
        srv.close()

    srv1 = TheaterServer(bundle, str(tmp_path / "b"), num_steps=3,
                         batch_window_s=0.0)
    try:
        srv1.open_session("d")
        srv1.run_turn("d", SPEC_A, timeout=900)
    finally:
        srv1.close()
    srv2 = TheaterServer(bundle, str(tmp_path / "b"), num_steps=3,
                         batch_window_s=0.0)
    try:
        s = srv2.open_session("d")                       # resume
        assert s.turn_index == 1
        resumed = srv2.run_turn("d", SPEC_A, timeout=900)
        assert s.turn_index == 2
    finally:
        srv2.close()
    np.testing.assert_array_equal(resumed.image, cont.image)


def test_unknown_session_and_close(server):
    with pytest.raises(KeyError):
        server.submit("nope", SPEC_A)
    server.open_session("c")
    server.close_session("c")
    with pytest.raises(KeyError):
        server.submit("c", SPEC_A)


def test_http_facade(bundle, tmp_path):
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3)
    httpd = serve_http(srv, str(tmp_path / "out"), port=0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"

    def post(path, obj):
        req = urllib.request.Request(
            base + path, json.dumps(obj).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read())

    try:
        code, health = 200, json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=30).read())
        assert health["sessions"] == 0
        code, out = post("/sessions", {"id": "h1"})
        assert code == 201 and out["id"] == "h1"
        code, out = post("/sessions/h1/turns", dict(SPEC_A, seed=0))
        assert code == 200
        assert out["detections"] is not None
        import os
        assert os.path.exists(out["image"])
        # turn failures must yield a JSON error response, not a dropped
        # connection: a spec without gen_boxes fails inside the worker
        bad = {k: v for k, v in SPEC_A.items() if k != "gen_boxes"}
        try:
            post("/sessions/h1/turns", dict(bad, seed=1))
            raise AssertionError("expected an HTTP error")
        except urllib.error.HTTPError as e:
            assert e.code in (400, 500)
            assert "error" in json.loads(e.read())
    finally:
        httpd.shutdown()
        srv.close()


# ---- the arrival-aware wave policy ------------------------------------

def test_wave_policy_decision_table(bundle, tmp_path):
    """_wait_for_peers: the window only when peers are dense or queued."""
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=0.2)
    try:
        assert srv.wave_policy == "auto"
        assert srv._wait_for_peers()          # no arrival history yet
        srv._gap_ema = 5.0
        assert not srv._wait_for_peers()      # sparse: gaps >> window
        srv._gap_ema = 0.05
        assert srv._wait_for_peers()          # bursty: peer imminent
        srv.wave_policy = "always"
        srv._gap_ema = 5.0
        assert srv._wait_for_peers()          # forced window
        srv.wave_policy = "never"
        srv._gap_ema = 0.0
        assert not srv._wait_for_peers()      # forced serial
    finally:
        srv.close()


def test_wave_policy_auto_sparse_dispatches_solo(bundle, tmp_path):
    """With a long window and sparse observed arrivals, auto must not hold
    a lone request until the window closes."""
    import time as _time

    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=30.0)
    try:
        srv.open_session("s0")
        srv._gap_ema = 60.0       # pre-observed sparse regime
        t0 = _time.monotonic()
        res = srv.run_turn("s0", SPEC_A, seed=0, timeout=600)
        took = _time.monotonic() - t0
        assert np.isfinite(res.image).all()
        assert took < 25.0, f"window was not skipped ({took:.1f}s)"
        assert srv.stats()["waves"] == 0
    finally:
        srv.close()


def test_wave_policy_auto_saturated_still_batches(bundle, tmp_path):
    """Sparse EMA must not defeat batching when peers are ALREADY queued
    at dispatch (saturated regime: queue non-empty wins)."""
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=0.5)
    try:
        for sid in ("a", "b", "c"):
            srv.open_session(sid)
        f0 = srv.submit("a", SPEC_A, seed=0)     # occupies the worker
        f1 = srv.submit("b", SPEC_B, seed=1)     # queue behind it
        f2 = srv.submit("c", SPEC_A, seed=2)
        srv._gap_ema = 999.0                     # pretend sparse history
        for f in (f0, f1, f2):
            assert np.isfinite(f.result(timeout=900).image).all()
        assert srv.stats()["waves"] >= 1
    finally:
        srv.close()


def test_wave_policy_never_is_serial(bundle, tmp_path):
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=3,
                        batch_window_s=0.5, wave_policy="never")
    try:
        srv.open_session("a")
        srv.open_session("b")
        f1 = srv.submit("a", SPEC_A, seed=0)
        f2 = srv.submit("b", SPEC_B, seed=1)
        f1.result(timeout=900), f2.result(timeout=900)
        assert srv.stats()["waves"] == 0
        assert srv.stats()["turns"] == 2
    finally:
        srv.close()


def test_wave_policy_validation():
    with pytest.raises(ValueError, match="wave_policy"):
        TheaterServer(None, "/tmp/nonexistent", wave_policy="sometimes")
