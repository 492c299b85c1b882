"""Work counts of the kernels on known shapes."""
import pytest
import torch

from cambench.work import (F32_FLOPS_PER_S, HBM_BYTES_PER_S, PAD_ID,
                           least_seconds, price_call, price_grid_work,
                           profile_grid_work)


def price_args(k=2, p=100, c=3, policy="lru", caps=((1, 50, 200),
                                                    (0, 99, 100))):
    f32s = torch.zeros((k, 16))
    i32s = torch.zeros((k, 8), dtype=torch.int32)
    i32s[:, 0] = 100                     # n_distinct
    caps_i = torch.as_tensor(caps, dtype=torch.int32)
    ids = torch.arange(k * c, dtype=torch.int32).reshape(k, c)
    args = (policy, torch.zeros((k, p)), torch.zeros((k, p)), None, f32s,
            i32s, caps_i.float(), caps_i, ids)
    return price_call(args, {"has_sorted": False})


def test_price_lru_counts_one_pass_per_live_cell():
    call = price_args()
    nbytes, ops = price_grid_work(call)
    # probs 800 + f32s 128 + i32s 64 + caps_f 24 + caps_i 24 + ids 24,
    # h 24, best value and id 8
    assert nbytes == 800 + 128 + 64 + 24 + 24 + 24 + 24 + 8
    # live cells: caps 1 and 50 (row 0), 99 (row 1); 200, 0, 100 are closed
    assert ops == 3 * 4 * 100


def test_price_pad_cells_and_lfu():
    call = price_args(policy="lfu")
    call["ids"][0, 1] = PAD_ID
    nbytes, ops = price_grid_work(call)
    assert nbytes == 800 * 2 + 128 + 64 + 24 * 3 + 24 + 8
    assert ops == 1 + 99


def test_price_multi_reads_policy_column():
    call = price_args(policy="multi")
    call["i32s"][1, 3] = 1               # row 1 fifo
    _, ops = price_grid_work(call)
    assert ops == 2 * 4 * 100 + 6 * 100


def test_profile_counts_nonzero_table_entries():
    keys = torch.as_tensor([[0, 1, -1], [2, 2, 3]], dtype=torch.int32)
    lut = torch.as_tensor([[1.0, 0.0, 0.5], [0.0, 0.0, 1.0],
                           [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]])
    call = {"keys": keys, "pages": torch.zeros(3, dtype=torch.int32),
            "lut": lut, "bands": torch.zeros((2, 2), dtype=torch.int32),
            "c_ipp": 2, "pad": 10}
    nbytes, ops = profile_grid_work(call)
    assert ops == 2 + 1 + 3 + 3 + 0
    assert nbytes == 24 + 12 + 48 + 16 + 2 * 10 * 4


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(HBM_BYTES_PER_S, 0) == pytest.approx(1.0)
    assert least_seconds(0, F32_FLOPS_PER_S * 2) == pytest.approx(2.0)
