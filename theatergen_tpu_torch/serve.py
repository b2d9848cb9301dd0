"""The turn server: a batching request queue over the orchestrator.

The port of ``theatergen_tpu/serve.py``.  The reference is a batch CLI
(``generate.py`` walks a dataset serially); a deployment needs a process
that takes turn requests of many dialogues at once and keeps the card
busy.  This is that as a library (the standard library's threads and
``concurrent.futures``), with an HTTP facade on ``http.server``.

- A :class:`Session` is one dialogue: its own character DB directory and
  :class:`~theatergen_tpu_torch.theater.Theater`, over the server's one
  bundle.
- A session's turns depend on each other through its DB, so it has one
  turn in flight at a time; the worker gathers the turns of different
  sessions that arrive within ``batch_window_s`` into one
  :func:`~theatergen_tpu_torch.theater.run_turn_wave` (their characters in
  one batch, their final passes in another).  A lone turn runs the serial
  ``run_turn``.
- Backpressure: ``submit`` returns a ``Future``; ``max_queue`` bounds the
  accepted turns not yet finished, and ``ServerBusy`` is raised beyond it.
- A failed wave takes the quarantine path: each of its turns reruns
  serially with its seed (the wave rolled its DB writes back), a turn the
  wave finished is reused, and an error of a rerun reaches that request's
  future.

Each dispatch leaves spans in the sessions' Theater timers
(``utils/profiling.PhaseTimer``): every turn's ``serve.queue`` (its wait
from ``submit`` to its dispatch) in its own session's, and ``serve.wave``
(the run, parent of the Theaters' phases) and ``serve.reply`` (the
replies) in the first session's; all spans of one dispatch share its tag,
and :meth:`TheaterServer.dispatch_spans` (``GET /spans``) gathers them.

All device work runs on the worker thread, on its current stream (the
kernel wrappers launch on ``torch.cuda.current_stream()``); the lazy
kernel build (``_build.library``) holds a lock, so a first wave that
builds them is safe.

With ``mesh=`` (``parallel/mesh.make_mesh``; the server runs on rank 0)
every session's Theater runs over the mesh: a wave's character and final
batches go through the dp runners (``parallel/driver.py``) to the other
ranks, which serve them (``parallel/worker.py``).  A failure on another
rank (``parallel.worker.RankError``) fails its wave's requests and closes
the server (``failed`` is set): the mesh does not go on.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .db import CharacterDB
from .parallel.worker import RankError
from .theater import Theater, TurnResult, run_turn_wave
from .utils.profiling import dispatch_tag


class ServerBusy(RuntimeError):
    """Raised by submit() when the pending-turn queue is full."""


# session ids become directory names under db_root/out_dir — restrict to a
# safe charset (no separators, no leading dot) so an HTTP client can't
# write outside the configured roots
_SESSION_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}$")


def _set_result(fut: Future, res) -> None:
    """Resolve a future, tolerating client-side cancellation races."""
    try:
        fut.set_result(res)
    except Exception:       # noqa: BLE001 — cancelled/raced future
        pass


def _set_exception(fut: Future, err: BaseException) -> None:
    try:
        fut.set_exception(err)
    except Exception:       # noqa: BLE001 — cancelled/raced future
        pass


@dataclass
class _Request:
    session_id: str
    spec: dict
    seed: int
    future: Future = field(default_factory=Future)
    # turn number assigned by the worker atomically with completion, so
    # pipelined same-session requests can't both read the post-bump index
    turn_no: int = -1
    # when _submit accepted it: its wait to dispatch is ``serve.queue``
    submitted: float = field(default_factory=time.perf_counter)


class Session:
    def __init__(self, session_id: str, theater: Theater):
        self.id = session_id
        self.theater = theater
        self.turn_index = 0
        self.submitted = 0   # turns ever accepted (includes in-flight)
        # ordering invariant: at most ONE request of a session is ever in
        # the global queue / in flight; the rest wait here in FIFO order
        self.active = False
        self.pending: "list[_Request]" = []


class TheaterServer:
    """Batching turn server over one shared bundle.

    Parameters
    ----------
    bundle : Bundle
        Built once (``init_bundle`` / ``load_bundle``); every session
        shares it.
    db_root : str
        Directory; each session keeps its character DB in a subdirectory.
    mesh : optional ``parallel.mesh.Mesh`` (this process is its rank 0):
        the sessions' character batches and waves run over its ranks.
    max_wave : the most turns batched into one wave.
    wave_policy : ``"auto"`` (wait the window for peers only when turns
        arrive densely or peers are already queued), ``"always"`` or
        ``"never"`` (every turn serial).
    theater_kwargs : forwarded to every session's Theater (num_steps,
        guided, use_controlnet, ...).
    """

    def __init__(self, bundle, db_root: str, *, mesh=None,
                 max_wave: int = 8, batch_window_s: float = 0.05,
                 wave_policy: str = "auto",
                 max_queue: int = 64, **theater_kwargs):
        if mesh is not None and getattr(mesh, "rank", None) != 0:
            raise ValueError("TheaterServer runs on the mesh's rank 0; the "
                             "other ranks run parallel.worker.serve")
        self.bundle = bundle
        self.db_root = db_root
        self.max_wave = max(1, int(max_wave))
        self.batch_window_s = float(batch_window_s)
        if wave_policy not in ("auto", "always", "never"):
            raise ValueError(f"wave_policy must be auto/always/never, "
                             f"got {wave_policy!r}")
        self.wave_policy = wave_policy
        # arrival-rate tracking for the "auto" policy: an EMA of the gaps
        # between submits.  A wave's window holds an early arrival until
        # its peers come, which pays off only where they come soon, so
        # "auto" waits only when arrivals are at least window-dense or
        # peers are already queued at dispatch
        self._gap_ema: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self.max_queue = int(max_queue)
        self.theater_kwargs = dict(theater_kwargs, mesh=mesh)
        # set (with ``failure``) when a rank of the mesh failed
        self.failed = threading.Event()
        self.failure: Optional[BaseException] = None
        self.sessions: Dict[str, Session] = {}
        self._lock = threading.Lock()
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._pending = 0
        self.waves_run = 0            # observability (and test hooks)
        self.turns_done = 0
        self._dispatches = 0          # the span records' dispatch tags
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="theater-serve-worker")
        self._worker.start()

    # ---- session management ------------------------------------------
    def _state_path(self, session_id: str) -> str:
        return os.path.join(self.db_root, session_id, "session.json")

    def open_session(self, session_id: str) -> Session:
        """Open (or resume) a session.  Alongside the character DB, a tiny
        ``session.json`` in the session's DB dir persists the turn/seed
        counters, so a server restart resumes the dialogue exactly where
        it stopped — auto-derived seeds keep advancing instead of
        restarting at turn 0 (which would replay turn-0 noise), and the
        DB keeps chaining character identity across the restart."""
        if not _SESSION_ID_RE.fullmatch(session_id):
            # ids become directory names; reject path separators /
            # traversal / empty (HTTP clients reach this directly).
            # fullmatch, not match: `$` alone still accepts a trailing
            # newline ("abc\n" is a legal JSON string value)
            raise ValueError(f"invalid session id: {session_id!r} "
                             "(letters, digits, . _ -; no leading dot)")
        with self._lock:
            if self._stop:
                raise RuntimeError("server closed")
            if session_id in self.sessions:
                raise ValueError(f"session exists: {session_id}")
            self.sessions[session_id] = None   # reserve the id
        # disk IO + Theater/pipeline construction happen OUTSIDE the lock
        # so concurrent submits of other sessions don't stall on them
        try:
            db = CharacterDB(os.path.join(self.db_root, session_id))
            th = Theater(self.bundle, db, **self.theater_kwargs)
            s = Session(session_id, th)
            try:
                with open(self._state_path(session_id)) as f:
                    st = json.load(f)
                s.turn_index = int(st.get("turn_index", 0))
                s.submitted = int(st.get("submitted", s.turn_index))
            except FileNotFoundError:
                pass
            except (ValueError, TypeError, AttributeError):
                # corrupt state file (truncated json, non-dict top level,
                # null fields): start the counters fresh rather than
                # bricking the session id
                s.turn_index = s.submitted = 0
        except BaseException:
            with self._lock:
                self.sessions.pop(session_id, None)
            raise
        with self._lock:
            self.sessions[session_id] = s
        return s

    def _persist_session(self, s: Session) -> None:
        # persist submitted == turn_index (not the live counter): turns
        # that were in flight at a crash produced no output, so their
        # reruns after resume should REUSE their seeds — the restarted
        # dialogue then reproduces an uninterrupted one exactly.
        # Best-effort: a persist I/O failure must not fail the turn (the
        # result is already computed; resume then restarts counters at the
        # last successful persist)
        try:
            path = self._state_path(s.id)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"turn_index": s.turn_index,
                           "submitted": s.turn_index}, f)
            os.replace(tmp, path)
        except OSError as e:
            import sys

            print(f"[serve] session {s.id}: state persist failed: {e}",
                  file=sys.stderr)

    def close_session(self, session_id: str) -> None:
        with self._lock:
            if (session_id in self.sessions
                    and self.sessions[session_id] is None):
                # mid-open reservation: popping it would let a concurrent
                # open_session build a second Theater on the same DB dir
                raise RuntimeError(
                    f"session {session_id} is still being opened")
            s = self.sessions.get(session_id)
            if s is not None and (s.active or s.pending):
                raise RuntimeError(
                    f"session {session_id} has queued/in-flight turns")
            self.sessions.pop(session_id, None)

    # ---- request path --------------------------------------------------
    def submit(self, session_id: str, spec: dict,
               seed: Optional[int] = None) -> "Future[TurnResult]":
        """Queue one turn; the Future resolves to a TurnResult."""
        return self._submit(session_id, spec, seed).future

    def _submit(self, session_id: str, spec: dict,
                seed: Optional[int]) -> _Request:
        if seed is not None:
            # validate BEFORE any counter mutation: a bad client seed must
            # not leak a pending slot or shift the session's seed stream
            try:
                seed = int(seed)
            except (TypeError, ValueError):
                raise ValueError(f"seed must be an integer, got {seed!r}")
        with self._lock:
            if self._stop:
                raise RuntimeError("server closed")
            s = self.sessions.get(session_id)
            if s is None:
                raise KeyError(f"unknown session: {session_id}")
            if self._pending >= self.max_queue:
                raise ServerBusy(f"{self._pending} turns pending")
            self._pending += 1
            now = time.monotonic()
            if self._last_arrival is not None:
                gap = now - self._last_arrival
                self._gap_ema = (gap if self._gap_ema is None
                                 else 0.5 * self._gap_ema + 0.5 * gap)
            self._last_arrival = now
            if seed is None:
                # the reference derives per-turn seeds from the dialogue
                # index + turn index (generate.py:236-243); sessions do
                # the same from the full 32-bit id CRC (x100k stride) on
                # ever-accepted turn count — turn_index alone would
                # collide for a turn submitted while its predecessor is
                # in flight, and a 16-bit bucket collides across a few
                # hundred concurrent session names
                import zlib

                seed = (zlib.crc32(session_id.encode()) * 100_000
                        + s.submitted)
            s.submitted += 1
            req = _Request(session_id, spec, seed)
            if s.active:
                s.pending.append(req)       # strict per-dialogue FIFO
            else:
                s.active = True
                self._queue.put(req)
        return req

    def run_turn(self, session_id: str, spec: dict,
                 seed: Optional[int] = None,
                 timeout: Optional[float] = None) -> TurnResult:
        """Synchronous convenience wrapper."""
        return self.submit(session_id, spec, seed).result(timeout)

    def run_turn_numbered(self, session_id: str, spec: dict,
                          seed: Optional[int] = None,
                          timeout: Optional[float] = None
                          ) -> "tuple[int, TurnResult]":
        """Like run_turn, but also returns the 1-based turn number the
        worker assigned atomically with completion (reading
        ``session.turn_index`` after the fact races pipelined requests)."""
        req = self._submit(session_id, spec, seed)
        res = req.future.result(timeout)
        return req.turn_no, res

    # ---- lifecycle -----------------------------------------------------
    def close(self, timeout: float = 60.0) -> None:
        with self._lock:
            self._stop = True
        self._queue.put(None)
        self._worker.join(timeout)
        # fail accepted-but-unexecuted turns: their futures would
        # otherwise hang callers forever (the worker exits on the stop
        # sentinel before promoted session-pending requests run)
        err = RuntimeError("server closed")
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                _set_exception(r.future, err)
        with self._lock:
            for s in self.sessions.values():
                if s is None:
                    continue
                for r in s.pending:
                    _set_exception(r.future, err)
                s.pending.clear()
        if self._worker.is_alive():
            # the join timed out mid-wave and the drain above may have
            # consumed the stop sentinel — re-arm it so the worker exits
            # after its wave instead of blocking in _queue.get() forever
            self._queue.put(None)

    def stats(self) -> dict:
        return dict(sessions=len(self.sessions), pending=self._pending,
                    waves=self.waves_run, turns=self.turns_done,
                    wave_policy=self.wave_policy, gap_ema_s=self._gap_ema)

    def dispatch_spans(self, tag: Optional[int] = None) -> dict:
        """The span records of one dispatch, by default the newest (which
        may still run): every open session's spans under its tag, in start
        order, each with its session.  A span's parent may be another
        session's span (``serve.wave`` parents the wave's phases)."""
        with self._lock:
            tag = self._dispatches if tag is None else int(tag)
            live = [s for s in self.sessions.values() if s is not None]
        spans = [dict(sp._asdict(), session=s.id) for s in live
                 # a copy in one C call: the worker may append meanwhile
                 for sp in s.theater.timer.spans.copy() if sp.tag == tag]
        spans.sort(key=lambda sp: sp["start_ns"])
        return {"tag": tag, "spans": spans}

    # ---- worker ---------------------------------------------------------
    def _wait_for_peers(self) -> bool:
        """Arrival-aware batching decision, taken once per dispatch with
        one request in hand:

        - ``always``: wait the batch window.
        - ``never``: dispatch solo at once.
        - ``auto`` (default): wait only if peers are already queued (the
          saturated regime: batching them costs no waiting), or if the
          inter-arrival EMA is within the batch window (a burst: a peer
          is likely to come).  Sparse traffic (gaps longer than the
          window) dispatches solo, since the window would only delay it.
        """
        if self.wave_policy == "never":
            return False
        if self.wave_policy == "always":
            return True
        if not self._queue.empty():
            return True                       # saturated: peers waiting now
        gap = self._gap_ema
        return gap is None or gap <= self.batch_window_s

    def _take_wave(self) -> List[_Request]:
        """Block for one request, then gather the ones arriving inside the
        batch window (policy permitting — see :meth:`_wait_for_peers`).
        submit() guarantees at most one queued request per session, so
        every take is wave-compatible."""
        first = self._queue.get()
        if first is None:
            return []
        wave = [first]
        if not self._wait_for_peers():
            return wave
        deadline = time.monotonic() + self.batch_window_s
        while len(wave) < self.max_wave:
            rest = deadline - time.monotonic()
            if rest <= 0:
                break
            try:
                nxt = self._queue.get(timeout=rest)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)       # keep the stop signal
                break
            wave.append(nxt)
        return wave

    def _run(self) -> None:
        while True:
            wave = self._take_wave()
            if not wave:
                return
            # slots: every session with a taken request (live, cancelled,
            # or closed-session) — its queue slot must be released in the
            # finally even when the request never executes
            theaters, specs, seeds, live, slots = [], [], [], [], []
            for r in wave:
                with self._lock:
                    s = self.sessions.get(r.session_id)
                if s is None:
                    _set_exception(r.future,
                                   KeyError(f"session closed: "
                                            f"{r.session_id}"))
                    continue
                slots.append(s)
                if not r.future.set_running_or_notify_cancel():
                    continue    # client cancelled while queued
                theaters.append(s.theater)
                specs.append(r.spec)
                seeds.append(r.seed)
                live.append((r, s))
            try:
                if not live:
                    continue
                self._dispatches += 1
                with dispatch_tag(self._dispatches):
                    self._dispatch(live, theaters, specs, seeds)
            finally:
                with self._lock:
                    # every taken request was counted at submit time —
                    # including cancelled and closed-session ones
                    self._pending -= len(wave)
                    for s in slots:
                        # release the session's queue slot; promote its
                        # next pending turn (strict FIFO) — unless the
                        # server is stopping, in which case promotion
                        # would race close()'s queue drain and strand
                        # the future
                        if s.pending and not self._stop:
                            self._queue.put(s.pending.pop(0))
                        elif s.pending:
                            for r in s.pending:
                                _set_exception(
                                    r.future,
                                    RuntimeError("server closed"))
                            s.pending.clear()
                            s.active = False
                        else:
                            s.active = False

    def _resolve(self, r: _Request, s: Session, res: TurnResult) -> None:
        s.turn_index += 1
        r.turn_no = s.turn_index
        self.turns_done += 1
        self._persist_session(s)
        _set_result(r.future, res)

    def _dispatch(self, live, theaters, specs, seeds) -> None:
        """Run one wave (or lone turn) and resolve its futures.  Each
        turn's wait since ``submit`` goes into its session's timer as
        ``serve.queue``; into the first session's, the run as a
        ``serve.wave`` phase and the replies (each session's state
        written, each future resolved) as a ``serve.reply`` phase, which
        on a failed wave holds the quarantine's serial reruns and
        resolutions."""
        now = time.perf_counter()
        for r, s in live:
            s.theater.timer.add("serve.queue", now - r.submitted)
        timer = theaters[0].timer
        try:
            with timer.phase("serve.wave"):
                if len(live) == 1:
                    results = [theaters[0].run_turn(specs[0], seeds[0])]
                else:
                    results = run_turn_wave(theaters, specs, seeds)
                    self.waves_run += 1
            with timer.phase("serve.reply"):
                for (r, s), res in zip(live, results):
                    self._resolve(r, s, res)
        except RankError as rank_exc:
            # the mesh lost a rank: no rerun can succeed
            for r, _ in live:
                _set_exception(r.future, rank_exc)
            with self._lock:
                self._stop = True
            self.failure = rank_exc
            self.failed.set()
        except Exception as wave_exc:   # noqa: BLE001
            if len(live) == 1:
                r, _ = live[0]
                _set_exception(r.future, wave_exc)
                return
            # per-request isolation: one bad spec must not fail its
            # wave-mates.  As the CLI's quarantine does, each turn reruns
            # serially with its own seed (run_turn_wave rolled the batch's
            # DB writes back), reusing the turns WaveFailure carries
            # (finished serially, their DB writes durable).  A resolved
            # future is skipped: rerunning its turn would advance its
            # session twice
            partial = getattr(wave_exc, "results", {})
            with timer.phase("serve.reply"):
                for w_idx, ((r, s), spec, seed) in enumerate(
                        zip(live, specs, seeds)):
                    if r.future.done():
                        continue
                    try:
                        res = (partial[w_idx] if w_idx in partial
                               else s.theater.run_turn(spec, seed))
                    except Exception as e:  # noqa: BLE001 — to caller
                        _set_exception(r.future, e)
                    else:
                        self._resolve(r, s, res)


# ---- optional HTTP facade (stdlib only) --------------------------------

def make_http_handler(server: TheaterServer, out_dir: str):
    """A minimal JSON/HTTP facade:

    - ``POST /sessions``              {"id": "dlg1"}
    - ``POST /sessions/<id>/turns``   CMIGBench turn spec (+opt "seed")
      → {"image": "<out_dir>/<id>/turn_<n>.png", "detections": [...]}
    - ``GET  /healthz``               stats
    - ``GET  /spans[?tag=<n>]``       a dispatch's span records (the
      newest by default): where its time went, phase by phase

    Images are written to ``out_dir`` (returning file paths keeps the
    facade dependency-free; a fronting service can stream them).
    """
    import http.server
    import urllib.parse

    from .cli.generate import save_image

    class Handler(http.server.BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):          # quiet test runs
            pass

        def do_GET(self):
            url = urllib.parse.urlsplit(self.path)
            if url.path == "/healthz":
                self._json(200, server.stats())
            elif url.path == "/spans":
                tag = urllib.parse.parse_qs(url.query).get("tag", [None])[0]
                try:
                    self._json(200, server.dispatch_spans(tag))
                except ValueError as e:
                    self._json(400, {"error": f"bad tag: {e}"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request body: {e}"})
                return
            parts = [p for p in self.path.split("/") if p]
            try:
                if parts == ["sessions"]:
                    s = server.open_session(str(payload["id"]))
                    self._json(201, {"id": s.id})
                elif (len(parts) == 3 and parts[0] == "sessions"
                        and parts[2] == "turns"):
                    sid = parts[1]
                    seed = payload.pop("seed", None)
                    turn, res = server.run_turn_numbered(sid, payload, seed)
                    path = os.path.join(out_dir, sid, f"turn_{turn}.png")
                    save_image(path, res.image)
                    self._json(200, {"image": path,
                                     "seconds": res.seconds,
                                     "detections": res.detections})
                else:
                    self._json(404, {"error": "not found"})
            except ServerBusy as e:
                self._json(429, {"error": str(e)})
            except (KeyError, ValueError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:          # noqa: BLE001 — turn execution
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_http(server: TheaterServer, out_dir: str, port: int = 8787):
    """Build a bound ThreadingHTTPServer over the facade and return it —
    the caller runs ``httpd.serve_forever()`` (see :func:`main`)."""
    import http.server

    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", port), make_http_handler(server, out_dir))
    return httpd


def main(argv=None, **launch) -> None:
    """``python -m theatergen_tpu_torch.serve``: the HTTP turn server.

    The bundle's flags are the generation CLI's (``--tiny``,
    ``--sd_version``, ``--weights``, ``--snapshot``, ``--device``, the
    sampler knobs); the serving flags set batching and backpressure.
    Sessions resume across restarts (:meth:`TheaterServer.open_session`).
    ``--mesh dp=N[,tp=M]`` serves over a mesh of N·M ranks that the
    command spawns, as the generation CLI's ``--mesh`` does."""
    from .cli import generate as gen_cli

    args = make_parser().parse_args(argv)
    gen_cli.check_ported(args)
    if args.mesh is None:
        run_program(args, gen_cli.build_theater(args), None)
    else:
        gen_cli.launch_mesh(__name__, args, argv, **launch)


def make_parser():
    import argparse

    from .cli import generate as gen_cli

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--db_root", default="serve_db")
    ap.add_argument("--out_dir", default="serve_out")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the bundle (default: the card)")
    ap.add_argument("--sd_version", default="1.5", choices=["1.5", "xl"])
    ap.add_argument("--weights", default=None)
    ap.add_argument("--snapshot", default=None)
    ap.add_argument("--mesh", default=None, metavar="dp=N[,tp=M]")
    ap.add_argument("--num_steps", type=int, default=None)
    ap.add_argument("--max_wave", type=int, default=8)
    ap.add_argument("--batch_window_s", type=float, default=0.05)
    ap.add_argument("--wave_policy", default="auto",
                    choices=["auto", "always", "never"],
                    help="auto: batch when peers are queued or arrivals "
                         "are dense, solo when sparse; always: always wait "
                         "the window; never: serial")
    ap.add_argument("--max_queue", type=int, default=64)
    ap.add_argument("--scheduler", default=None,
                    choices=["ddim", "euler_ancestral", "lcm"])
    ap.add_argument("--cfg_cutoff", type=float, default=None)
    ap.add_argument("--deepcache", type=int, default=None)
    ap.add_argument("--cn_interval", type=int, default=None)
    ap.add_argument("--guidance", action="store_true",
                    help="latent guidance in the character and final "
                         "passes (off by default)")
    ap.add_argument("--no_guidance", action="store_true",
                    help="(deprecated: guidance is off by default)")
    return ap


def run_program(args, bundle, mesh) -> None:
    """Serve HTTP until interrupted, or until a rank of the mesh fails
    (which raises its ``RankError``)."""
    server = TheaterServer(
        bundle, args.db_root, mesh=mesh, max_wave=args.max_wave,
        batch_window_s=args.batch_window_s, wave_policy=args.wave_policy,
        max_queue=args.max_queue, num_steps=args.num_steps,
        guided=args.guidance and not args.no_guidance)
    httpd = serve_http(server, args.out_dir, args.port)
    print(f"theatergen serving on http://127.0.0.1:"
          f"{httpd.server_address[1]} (db={args.db_root}, "
          f"out={args.out_dir})", flush=True)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                                   name="theater-http")
    http_thread.start()
    try:
        while not server.failed.wait(0.5):
            pass
        raise server.failure
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
