"""The frozen FLOP and byte counts against hand counts at small shapes."""
from hetbench import costs, families

Z = {"family": "moe", "L": 2, "d": 8, "ff": 4, "vocab": 10, "H": 2,
     "KV": 1, "hd": 4, "E": 3, "K": 2}


def test_decode_paged_counts():
    f, b = costs.decode_paged(Z, [3, 5])
    # q.k and p.v: 2 flops a multiply-add, 2 heads x 4 dims x 8 positions
    assert f == 2 * 2 * (2 * 4 * 8)
    # K and V of 8 positions x 1 kv head x 4 dims, q and out of 2 rows
    assert b == 2 * (2 * 1 * 4 * 8 + 2 * 2 * 4 * 2)


def test_attention_prefill_counts_causal_pairs_of_real_tokens():
    f, b = costs.attention_prefill(Z, [3])
    assert f == 4 * 2 * 4 * 6          # 3 + 2 + 1 pairs
    assert b == 2 * (2 * 2 + 2 * 1) * 4 * 3


def test_expert_gemms_read_every_expert_once():
    (f1, b1), (f2, b2) = costs.expert_gemms(Z, 5)
    n = 5 * 2
    assert f1 == 2 * n * 8 * 8 and f2 == 2 * n * 4 * 8
    assert b1 == 2 * (3 * 8 * 8 + n * (8 + 8))
    assert b2 == 2 * (3 * 4 * 8 + n * (4 + 8))


def test_wkv_counts():
    z = {"Hs": 2, "hds": 4}
    f, b = costs.wkv(z, [5, 7])
    assert f == 4 * 2 * 16 * 12
    assert b == 4 * (5 * 2 * 4 * 12 + 2 * 2 * 16)


def test_bound_takes_the_larger_side():
    assert costs.bound_s(989e12, 0, costs.PEAK_BF16) == 1.0
    assert costs.bound_s(0, 3.35e12, costs.PEAK_BF16) == 1.0


def test_model_flops():
    moe = families.load("moe")
    per = 8 * 4 * 4 + 8 * 8 + 8 * 3 + 2 * (8 * 8 + 4 * 8)
    assert moe.matmul_params(Z) == 2 * per + 8 * 10
    assert moe.prompt_flops(Z, 3) == 2 * moe.matmul_params(Z) * 3 + \
        2 * 4 * 2 * 4 * 6
    assert moe.token_flops(Z, 2) == 2 * moe.matmul_params(Z) + \
        2 * 4 * 2 * 4 * 3
    assert moe.train_flops(Z, 1, 3) == 6 * moe.matmul_params(Z) * 3 + \
        3 * 2 * 4 * 2 * 4 * 6


def test_rwkv6_model_flops():
    rwkv6 = families.load("rwkv6")
    z = {"L": 2, "d": 8, "ff": 4, "vocab": 10, "Hs": 2, "hds": 4}
    # r, k, v, g, o and the channel mix's receptance; the decay LoRA of
    # rank 64; the channel mix's two ff products; the head
    per = 6 * 8 * 8 + 2 * 8 * 64 + 2 * 8 * 4
    assert rwkv6.matmul_params(z) == 2 * per + 8 * 10
    # the state update and read-out: 4 hd^2 a head and token
    assert rwkv6.token_flops(z, 7) == 2 * rwkv6.matmul_params(z) + \
        2 * 4 * 2 * 16
    assert rwkv6.prompt_flops(z, 3) == 3 * rwkv6.token_flops(z, 0)
