"""The port's span records and counts (``utils/profiling.PhaseTimer``) and
where the program leaves them: the turn server's ``serve.queue``,
``serve.wave`` and ``serve.reply``, the orchestrator's loop, decode and DB
write phases and its ``char.jobs`` / ``char.attempts`` / ``loop.steps``
counts.  The timer on its own, then the tiny bundle on the CPU (3 DDIM
steps)."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from theatergen_tpu_torch import db as tdb
from theatergen_tpu_torch import theater as tth
from theatergen_tpu_torch.config import tiny_config
from theatergen_tpu_torch.pipelines.bundle import init_bundle
from theatergen_tpu_torch.serve import TheaterServer, serve_http
from theatergen_tpu_torch.utils import profiling
from theatergen_tpu_torch.utils.profiling import PhaseTimer, dispatch_tag

torch.set_num_threads(1)

STEPS = 3


def _spec(*chars):
    """A turn spec of ``chars`` = (phrase, box, obj_id) triples."""
    return {"prompt": " and ".join(c[0] for c in chars) + " in a room",
            "gen_boxes": [(c[0], c[1]) for c in chars],
            "bg_prompt": "a quiet room", "extra_neg_prompt": "",
            "obj_ids": [c[2] for c in chars],
            "canvas_height": 512, "canvas_width": 512}


KNIGHT = ("a red knight", (50, 100, 150, 300), 0)
DRAGON = ("a green dragon", (300, 80, 180, 350), 1)
CAT = ("a black cat", (200, 200, 120, 120), 0)


@pytest.fixture(scope="module")
def bundle():
    return init_bundle(tiny_config(), 0, device="cpu", with_ip=True,
                       with_controlnet=True, with_vision=True)


def _by_name(timer, name):
    return [s for s in timer.spans if s.name == name]


# ---------------------------------------------------------------------------
# the timer
# ---------------------------------------------------------------------------


def test_spans_nest_with_wall_clock_extents():
    """A phase's span: its wall-clock extent, the innermost phase open on
    its thread as its parent, across timers, and the dispatch tag around
    it; its samples as before."""
    outer_t, inner_t = PhaseTimer("cpu"), PhaseTimer("cpu")
    t0 = time.time_ns()
    with dispatch_tag(7):
        with outer_t.phase("outer", sync=True):
            with inner_t.phase("inner"):
                time.sleep(0.01)
            with inner_t.phase("inner"):
                pass
    with outer_t.phase("after"):
        pass
    t1 = time.time_ns()
    (outer,), (after,) = _by_name(outer_t, "outer"), _by_name(outer_t,
                                                               "after")
    first, second = inner_t.spans
    assert [s.name for s in inner_t.spans] == ["inner", "inner"]
    assert first.parent == second.parent == outer.id
    assert outer.parent is None and after.parent is None
    assert first.tag == second.tag == outer.tag == 7 and after.tag is None
    assert t0 <= outer.start_ns <= first.start_ns < first.end_ns \
        <= second.start_ns <= second.end_ns <= outer.end_ns <= after.start_ns \
        <= after.end_ns <= t1
    assert first.end_ns - first.start_ns >= 10e6
    assert len({outer.id, first.id, second.id, after.id}) == 4
    assert outer_t.counts() == {"outer": 1, "after": 1}
    assert inner_t.counts() == {"inner": 2}
    assert inner_t.samples["inner"][0] >= 0.01


def test_failed_synchronise_closes_the_phase(monkeypatch):
    """A synced phase whose synchronise raises (a sticky device error): the
    error reaches the caller, the phase keeps no sample and no span, and
    the thread's next phase is not taken for its child."""
    def broken(device=None):
        raise RuntimeError("sticky device error")

    monkeypatch.setattr(torch.cuda, "synchronize", broken)
    t = PhaseTimer("cuda")
    with pytest.raises(RuntimeError, match="sticky"):
        with t.phase("synced", sync=True):
            pass
    with t.phase("next"):
        pass
    assert t.counts() == {"next": 1}
    (nxt,) = t.spans
    assert nxt.name == "next" and nxt.parent is None


def test_span_buffer_is_bounded(monkeypatch):
    """The newest ``MAX_SPANS`` spans are kept; the samples keep all."""
    assert profiling.MAX_SPANS == 65536
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    t = PhaseTimer()
    for i in range(10):
        with t.phase(f"p{i}"):
            pass
    assert [s.name for s in t.spans] == ["p6", "p7", "p8", "p9"]
    assert sum(t.counts().values()) == 10


def test_add_and_count():
    """``add``: a sample of the given seconds and a span ending now, inside
    the open phase; ``count``: a sample of n, summarised as its total."""
    t = PhaseTimer()
    with t.phase("open"):
        before = time.time_ns()
        t.add("wait", 0.25)
        t.count("jobs")
        t.count("jobs", 3)
    (opened,), (wait,) = _by_name(t, "open"), _by_name(t, "wait")
    assert t.samples["wait"] == [0.25]
    assert wait.parent == opened.id
    assert wait.end_ns - wait.start_ns == 250_000_000
    assert wait.end_ns >= before
    assert t.samples["jobs"] == [1, 3]
    assert t.counts()["jobs"] == 2
    s = t.summary()
    assert s["jobs"] == {"count": 2, "total": 4.0}
    assert s["wait"]["total_s"] == 0.25 and s["open"]["count"] == 1
    assert json.loads(t.report())["jobs"]["total"] == 4.0
    assert not _by_name(t, "jobs")


def test_phases_reach_the_profiled_threads_trace_only(tmp_path):
    """Under ``torch.profiler`` a phase on the profiled thread is a range of
    its trace; one on another thread is not (the profiler's state is
    thread-local), though both leave their spans."""
    from torch.profiler import ProfilerActivity, profile

    t = PhaseTimer("cpu")

    def worker():
        with t.phase("from.worker"):
            torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("from.main"):
            torch.ones(8).sum()
        th = threading.Thread(target=worker)
        th.start()
        th.join(30)
    assert not th.is_alive()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "from.main" in names
    assert "from.worker" not in names
    assert {s.name for s in t.spans} == {"from.main", "from.worker"}


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def test_server_queue_wave_and_reply(bundle, tmp_path):
    """Two dispatches, a wave of two sessions and then session a alone: one
    ``serve.queue`` per turn in its session's timer, between 0 and the
    turn's latency; one ``serve.wave`` and one ``serve.reply`` per
    dispatch in its first session's timer, the wave's span the parent of
    the Theaters' phases, every span of a dispatch under its tag."""
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=STEPS,
                        wave_policy="always", batch_window_s=0.5,
                        max_wave=2)
    try:
        for sid in ("a", "b"):
            srv.open_session(sid)
        lat = {}

        def run(pairs):
            subs = [(sid, time.perf_counter(), srv.submit(sid, spec, seed))
                    for sid, spec, seed in pairs]
            for sid, t0, fut in subs:
                fut.result(600)
                lat.setdefault(sid, []).append(time.perf_counter() - t0)

        run([("a", _spec(KNIGHT), 0), ("b", _spec(DRAGON), 1)])
        run([("a", _spec(KNIGHT), 2)])
        ta = srv.sessions["a"].theater.timer
        tb = srv.sessions["b"].theater.timer
    finally:
        srv.close()
    assert srv.stats()["waves"] == 1 and srv.stats()["turns"] == 3
    for timer, sid in ((ta, "a"), (tb, "b")):
        waits = timer.samples["serve.queue"]
        assert len(waits) == len(lat[sid])
        assert all(0.0 <= q <= dt for q, dt in zip(waits, lat[sid]))
    assert ta.counts()["serve.wave"] == ta.counts()["serve.reply"] == 2
    assert "serve.wave" not in tb.counts()
    assert "serve.reply" not in tb.counts()
    waves, replies = _by_name(ta, "serve.wave"), _by_name(ta, "serve.reply")
    assert [w.tag for w in waves] == [r.tag for r in replies]
    assert len({w.tag for w in waves}) == 2
    for w, r in zip(waves, replies):
        assert w.parent is None and r.parent is None
        assert w.end_ns <= r.start_ns
    first = waves[0]
    for timer in (ta, tb):
        (q,) = [s for s in _by_name(timer, "serve.queue")
                if s.tag == first.tag]
        assert q.end_ns <= first.start_ns
        inside = [s for s in timer.spans if s.tag == first.tag
                  and s.name not in ("serve.queue", "serve.wave",
                                     "serve.reply")]
        assert inside
        for s in inside:
            assert first.start_ns <= s.start_ns <= s.end_ns <= first.end_ns
        assert {s.parent for s in inside if s.name in (
            "character", "char.encode_text")} == {first.id}
    (final,) = [s for s in _by_name(ta, "final") if s.tag == first.tag]
    assert final.parent == first.id


def test_dispatch_spans_over_http(bundle, tmp_path):
    """``GET /spans``: the newest dispatch's spans from every session's
    timer, in start order, each with its session; ``?tag=`` names an
    earlier dispatch, and a tag that is no number is refused."""
    srv = TheaterServer(bundle, str(tmp_path / "db"), num_steps=STEPS,
                        wave_policy="always", batch_window_s=0.5,
                        max_wave=2)
    httpd = serve_http(srv, str(tmp_path / "out"), port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/spans"

    def get(query=""):
        with urllib.request.urlopen(base + query, timeout=30) as r:
            return json.loads(r.read())

    try:
        for sid in ("a", "b"):
            srv.open_session(sid)
        futs = [srv.submit("a", _spec(KNIGHT), 0),
                srv.submit("b", _spec(DRAGON), 1)]
        for f in futs:
            f.result(600)
        srv.submit("b", _spec(DRAGON), 2).result(600)
        first, newest = get("?tag=1"), get()
        with pytest.raises(urllib.error.HTTPError) as bad:
            get("?tag=x")
        ta = srv.sessions["a"].theater.timer
        tb = srv.sessions["b"].theater.timer
    finally:
        httpd.shutdown()
        srv.close()
    assert bad.value.code == 400
    assert (first["tag"], newest["tag"]) == (1, 2)
    assert first == srv.dispatch_spans(1)
    for got in (first, newest):
        starts = [sp["start_ns"] for sp in got["spans"]]
        assert starts == sorted(starts)
    want = sorted([dict(sp._asdict(), session=sid)
                   for sid, t in (("a", ta), ("b", tb))
                   for sp in t.spans if sp.tag == 1],
                  key=lambda sp: sp["start_ns"])
    assert first["spans"] == want
    assert {sp["session"] for sp in first["spans"]} == {"a", "b"}
    (wave,) = [sp for sp in first["spans"] if sp["name"] == "serve.wave"]
    assert wave["session"] == "a"
    assert {sp["parent"] for sp in first["spans"]
            if sp["name"] == "final"} == {wave["id"]}
    assert {sp["session"] for sp in newest["spans"]} == {"b"}
    assert [sp["name"] for sp in newest["spans"]].count("serve.wave") == 1


def test_wave_counts_with_a_forced_detection_failure(bundle, tmp_path,
                                                     monkeypatch):
    """A wave of two dialogues (a: two characters, b: one; all DB misses)
    whose batched verdict fails a's first character, which then fails its
    serial attempt 0 and passes attempt 1: each job counted once in its own
    Theater, every character pass an attempt, the loops' steps exact, one
    ``db.save`` per DB miss in the dialogue's own timer."""
    real_batch, real_one = (tth.det.attention_detect_batch,
                            tth.det.attention_detect)
    serial_calls = []

    def batch_fails_first(maps):
        d = real_batch(maps)
        d.ok = torch.ones_like(d.ok)
        d.ok[0] = False
        return d

    def serial_fails_once(maps, word_token=None):
        d = real_one(maps, word_token)
        serial_calls.append(1)
        d.ok = torch.tensor(len(serial_calls) > 1)
        return d

    monkeypatch.setattr(tth.det, "attention_detect_batch",
                        batch_fails_first)
    monkeypatch.setattr(tth.det, "attention_detect", serial_fails_once)
    ths = [tth.Theater(bundle, tdb.CharacterDB(str(tmp_path / d)),
                       num_steps=STEPS) for d in ("a", "b")]
    res = tth.run_turn_wave(ths, [_spec(KNIGHT, DRAGON), _spec(CAT)],
                            [11, 12])
    assert [r.db_hits for r in res] == [[False, False], [False]]
    assert [r.detections for r in res] == [[True, True], [True]]
    assert len(serial_calls) == 2
    a, b = (th.timer for th in ths)
    s_char = ths[0].char_sched.num_steps
    s_final = ths[0].final_sched.num_steps
    assert a.summary()["char.jobs"] == {"count": 2, "total": 2.0}
    assert sum(a.samples["char.attempts"]) == 4
    assert sum(b.samples["char.jobs"]) == 1
    assert sum(b.samples["char.attempts"]) == 1
    # the batch of three and a's two serial attempts; the wave's final pass
    assert a.counts()["char.loop"] == a.counts()["char.decode"] == 3
    assert a.counts()["char.denoise_decode"] == 3
    assert a.counts()["final.loop"] == 1
    assert sum(a.samples["loop.steps"]) == 3 * s_char + s_final
    assert a.counts()["db.save"] == 2 and b.counts()["db.save"] == 1
    for name in ("char.loop", "char.decode", "final.loop", "loop.steps"):
        assert name not in b.counts()
    # the loop and the decode inside the synced pass, the loop first
    for dd in _by_name(a, "char.denoise_decode"):
        loop, dec = [s for s in a.spans if s.parent == dd.id
                     and s.name in ("char.loop", "char.decode")]
        assert (loop.name, dec.name) == ("char.loop", "char.decode")
        assert loop.end_ns <= dec.start_ns
    # every write inside the wave's final pass, after its own fetch
    (final,) = _by_name(a, "final")
    for s in _by_name(a, "db.save") + _by_name(b, "db.save"):
        assert s.parent == final.id


def test_serial_turn_counts(bundle, tmp_path, monkeypatch):
    """The serial turn: a job per unique character, an attempt per pass
    (attempt 0 fails, attempt 1 passes), one final pass, a DB write per
    miss, and the repeated character of a later turn a hit."""
    calls = []
    real_one = tth.det.attention_detect

    def fails_once(maps, word_token=None):
        d = real_one(maps, word_token)
        calls.append(1)
        d.ok = torch.tensor(len(calls) != 1)
        return d

    monkeypatch.setattr(tth.det, "attention_detect", fails_once)
    th = tth.Theater(bundle, tdb.CharacterDB(str(tmp_path / "s")),
                     num_steps=STEPS)
    th.run_turn(_spec(KNIGHT, DRAGON), 3)
    res = th.run_turn(_spec(KNIGHT), 4)
    assert res.db_hits == [True]
    t = th.timer
    assert sum(t.samples["char.jobs"]) == 3
    assert sum(t.samples["char.attempts"]) == 4
    assert t.counts()["char.denoise_decode"] == t.counts()["char.loop"] == 4
    assert sum(t.samples["loop.steps"]) == (
        4 * th.char_sched.num_steps + 2 * th.final_sched.num_steps)
    assert t.counts()["db.save"] == 2
    assert t.summary()["char.attempts"]["total"] == 4.0
