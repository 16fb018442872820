"""The traffic generator: reproducible by seed, the same sizes on every
seed, only their order and the content drawn from it."""

from collections import Counter
from pathlib import Path

from harness import traffic

BENCH = Path(__file__).resolve().parents[1]


def test_a_seed_gives_the_same_requests():
    mix = traffic.load_mix(BENCH, "chat")
    a, b = traffic.Plan(mix, 2**31 + 99), traffic.Plan(mix, 2**31 + 99)
    for slot, k in ((0, 0), (5, 3), (63, 17)):
        assert a.request(slot, k) == b.request(slot, k)


def test_seeds_share_sizes_and_differ_in_order_and_content():
    mix = traffic.load_mix(BENCH, "chat")
    plans = [traffic.Plan(mix, seed) for seed in (1, 2**32 + 5)]
    slots = int(mix["concurrency"])
    for block in range(3):
        sizes = [Counter(p.size("prompt_tokens", slot, block) for slot in range(slots))
                 for p in plans]
        assert sizes[0] == sizes[1] == Counter(
            traffic.quantile_values(mix["prompt_tokens"], slots))
    orders = [[p.size("output_tokens", slot, 0) for slot in range(slots)] for p in plans]
    assert orders[0] != orders[1]
    assert plans[0].request(0, 0)["prompt"] != plans[1].request(0, 0)["prompt"]


def test_prompts_are_unique_and_sized():
    mix = traffic.load_mix(BENCH, "chat")
    plan = traffic.Plan(mix, 7)
    prompts = [plan.request(slot, k) for slot in range(8) for k in range(1, 5)]
    assert len({p["prompt"] for p in prompts}) == len(prompts)
    for p in prompts:
        assert len(p["prompt"].split()) == plan.size("prompt_tokens", p["slot"], p["k"])
        assert 32 <= p["max_tokens"] <= 256


def test_quantile_values_follow_the_spec():
    lognormal = {"dist": "lognormal", "median": 128, "sigma": 0.8, "min": 16, "max": 512}
    values = traffic.quantile_values(lognormal, 32)
    assert values == sorted(values) and values[0] >= 16 and values[-1] <= 512
    assert values[15] <= 128 <= values[16]
    assert traffic.quantile_values({"dist": "uniform", "min": 0, "max": 100}, 4) == [12, 38, 62, 88]
    assert traffic.quantile_values({"dist": "fixed", "value": 7}, 3) == [7, 7, 7]


def test_token_ids_lie_in_the_vocabulary():
    mix = traffic.load_mix(BENCH, "ragged")
    plan = traffic.Plan(mix, 3, vocab_size=30522)
    for slot in range(32):
        ids = plan.request(slot, 0)["ids"]
        assert ids.min() >= 1 and ids.max() < 30522
        assert 16 <= len(ids) <= 512


def test_staggered_first_requests_ask_for_a_share_of_their_length():
    plan = traffic.Plan(traffic.load_mix(BENCH, "chat"), 21)
    firsts = [plan.request(slot, 0)["max_tokens"] for slot in range(64)]
    full = [plan.size("output_tokens", slot, 0) for slot in range(64)]
    assert all(1 <= a <= b for a, b in zip(firsts, full)) and firsts != full
    assert [plan.request(slot, 1)["max_tokens"] for slot in range(64)] == [
        plan.size("output_tokens", slot, 1) for slot in range(64)]
