"""The load generator: deterministic for a seed, the same work for every
seed, identical waves under the stagger, specs the port parses."""

import json

import pytest

from harness_tiny import BENCH

from harness.traffic import Traffic

MIXES = ("story_serve8", "story_serve4", "story_serial")
SEEDS = (0, 7, 2 ** 31 + 12345, 98765432109876)


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _shape(spec):
    return (len(spec["gen_boxes"]), tuple(spec["obj_ids"]))


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_for_a_seed(name):
    a, b = Traffic(_mix(name), SEEDS[2]), Traffic(_mix(name), SEEDS[2])
    for k in range(a.sessions):
        for n in range(6):
            assert a.turn(k, n) == b.turn(k, n)
        assert a.prefill(k) == b.prefill(k)
    assert a.check_sessions(3) == b.check_sessions(3)


@pytest.mark.parametrize("name", MIXES)
def test_seed_draws_only_content(name):
    """Every seed gives every session the same turn shapes (characters,
    ids, so DB hits) in the same order; the content differs."""
    shapes, contents = set(), set()
    for seed in SEEDS:
        t = Traffic(_mix(name), seed)
        shapes.add(tuple(_shape(t.turn(k, n)[0]) for k in range(t.sessions)
                         for n in range(8)))
        contents.add(json.dumps(t.turn(0, 0)))
        for k in range(t.sessions):
            assert len(t.prefill(k)) == len(
                {c for s in t.turns[:t.start(k)] for c in s})
    assert len(shapes) == 1 and len(contents) == len(SEEDS)


@pytest.mark.parametrize("name,want", [
    ("story_serve8", (12, (0, 0, 1, 1, 2, 2, 3, 3))),
    ("story_serve4", (6, (0, 1, 2, 3)))])
def test_stagger_gives_identical_waves(name, want):
    t = Traffic(_mix(name), SEEDS[1])
    rounds = []
    for n in range(8):
        specs = [t.turn(k, n)[0] for k in range(t.sessions)]
        chars = sum(len(s["gen_boxes"]) for s in specs)
        idx = sorted(t.position(k, n)[1] for k in range(t.sessions))
        rounds.append((chars, tuple(idx)))
    assert set(rounds) == {want}


def test_dialogues_use_fresh_ids():
    t = Traffic(_mix("story_serial"), SEEDS[0])
    ids = [set(t.turn(0, n)[0]["obj_ids"]) for n in range(9)]
    # offset 3: turn 0 ends dialogue 0, turns 1-4 are dialogue 1
    assert not ids[0] & ids[1] and ids[1] & ids[2]


@pytest.mark.parametrize("name", MIXES)
def test_specs_parse(name):
    from theatergen_tpu_torch.utils import parse

    t = Traffic(_mix(name), SEEDS[3])
    for k in range(t.sessions):
        for n in range(4):
            spec, seed = t.turn(k, n)
            assert 0 <= seed < 2 ** 31
            plan = parse.convert_spec(spec, 1024, 1024)
            assert len(plan.object_plans) == len(spec["gen_boxes"])
            for p in plan.object_plans:
                x0, y0, x1, y1 = p.box
                assert 0 <= x0 < x1 <= 1 and 0 <= y0 < y1 <= 1
                assert p.word in p.phrase


@pytest.mark.parametrize("name", ["story_serve8", "story_serve4"])
def test_check_covers_both_halves_and_the_longest(name):
    for seed in SEEDS:
        t = Traffic(_mix(name), seed)
        picks = t.check_sessions(t.mix["check_turns"])
        assert len(set(picks)) == len(picks) >= 2
        assert len(t.turns[t.start(picks[0])]) == 2
        assert {k < t.sessions // 2 for k in picks} == {True, False}
