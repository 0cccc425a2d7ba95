"""The yardstick's counts equal hand counts at small shapes."""
import pytest

from fedbench import counts

ENC = {"num_hidden_layers": 2, "hidden_size": 4, "num_attention_heads": 2,
       "num_key_value_heads": 2, "head_dim": 2, "intermediate_size": 8,
       "tokens_per_image": 3, "embed_dim": 5, "num_labels": 7,
       "lora_targets": ["q", "k", "v", "o", "up", "down"]}
DEC = {"num_hidden_layers": 2, "hidden_size": 4, "num_attention_heads": 2,
       "num_key_value_heads": 1, "head_dim": 2, "intermediate_size": 8,
       "vocab_size": 10, "dtype": "bfloat16",
       "lora_targets": ["q", "k", "v", "o", "up", "down"]}


def test_layer_and_lora_params():
    # q 4x4, k 4x4, v 4x4, o 4x4, up 4x8, down 8x4
    assert counts.layer_params(ENC) == 16 * 4 + 32 + 32
    # rank 2: q/k/v/o 2*(4+4) each, up 2*(4+8), down 2*(8+4)
    assert counts.lora_params(ENC, 2) == 4 * 16 + 24 + 24
    # GQA: k and v are 4x2
    assert counts.layer_params(DEC) == 16 + 8 + 8 + 16 + 32 + 32


def test_client_step_flops():
    b, r = 2, 1
    n = b * 3
    body = 2 * n * 2 * 128
    attn = 2 * 4 * b * 3 * 3 * 2 * 2
    head = 2 * b * 4 * 7
    fwd = body + 2 * n * 5 * 4 + attn + head
    bwd = body + 2 * attn + head
    lora = 6 * n * 2 * counts.lora_params(ENC, r)
    assert counts.client_step_flops(ENC, b, r) == fwd + bwd + lora
    assert counts.round_train_flops(ENC, b, 3, [1, 1]) == \
        6 * counts.client_step_flops(ENC, b, 1)


def test_k12_bound():
    # L 1, M 2 clients, d 3, n 5, r 2, no fallback: R = 4
    k1_in = 2 * 1 * 2 * 8 + 2 * 2
    k1_out = 1 * 4 * 8
    k2_out = 2 * 16
    want = (max(4 * (k1_in + k1_out) / counts.PEAK_BYTES_PER_S,
                k1_out / counts.PEAK_TF32X3_FLOPS)
            + max(4 * (k1_out + k2_out) / counts.PEAK_BYTES_PER_S,
                  4 * 5 * 8 / counts.PEAK_TF32X3_FLOPS))
    assert counts.k12_bound_s(1, 2, 3, 5, 2, False) == pytest.approx(want)
    # the fallback adds a client of the globals
    assert counts.k12_bound_s(1, 2, 3, 5, 2, True) > want


def test_k4_work():
    nbytes, flops = counts.k4_work(3, 4, 5, 2, 3, 2)
    assert nbytes == 2 * (3 * 4 + 4 * 5 + 3 * 2 * 9 + 3 * 5)
    assert flops == 2 * 3 * 4 * 5 + 2 * 3 * 2 * 9


def test_decode_step_work():
    nbytes, flops = counts.decode_step_work(DEC, [3, 5], [2, 2], [2])
    lp = counts.layer_params(DEC)
    weights = 2 * (lp + 8) + 4 * 10 + 4
    pages = 2 * counts.lora_params(DEC, 2)
    cache = 2 * 2 * 2 * (3 + 5)
    assert nbytes == 2 * (weights + pages + cache + 2 * 4 + 2 * 2 * 2 * 2
                          + 2 * 10)
    want = 2 * 2 * (2 * lp + 40) + 2 * 2 * 2 * counts.lora_params(DEC, 2)
    want += 2 * 4 * 4 * (4 + 6)
    assert flops == want


def test_prefill_row_flops():
    t, r = 5, 2
    lp, lo = counts.layer_params(DEC), counts.lora_params(DEC, r)
    want = 2 * t * 2 * (lp + lo) + 2 * 4 * 4 * t * (t + 1) / 2 + 2 * 4 * 10
    assert counts.prefill_row_flops(DEC, t, r) == want


def test_bound_takes_the_longer():
    assert counts.bound_s(3.35e12, 0, 1) == 1.0
    assert counts.bound_s(0, 989e12, counts.PEAK_BF16_FLOPS) == 1.0
