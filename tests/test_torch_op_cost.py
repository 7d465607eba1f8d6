"""`repro_torch.roofline.op_cost`: unit counts of its byte and FLOP
model, and the port's decode-step counts against the reference's at full
width for every decoder config but the two MoE ones
(tests/test_torch_op_cost_moe.py; tests/op_cost_cases.py says what is
equal and what parts)."""
import pytest
import torch

from op_cost_cases import check_block_costs
from repro_torch.configs import list_archs
from repro_torch.roofline.op_cost import count_costs, fake_mode

BF, F32 = torch.bfloat16, torch.float32


def _t(*shape, dtype=BF):
    return torch.zeros(shape, dtype=dtype)


def test_mm_counts_flops_and_operand_bytes():
    c = count_costs(torch.mm, _t(8, 64), _t(64, 32))
    assert c["flops"] == 2 * 8 * 64 * 32
    assert c["bytes"] == c["bytes_unfused"] == 2 * (8 * 64 + 64 * 32
                                                    + 8 * 32)
    c = count_costs(torch.addmm, _t(32, dtype=F32), _t(8, 64, dtype=F32),
                    _t(64, 32, dtype=F32))
    assert c["flops"] == 2 * 8 * 64 * 32
    assert c["bytes"] == 4 * (32 + 8 * 64 + 64 * 32 + 8 * 32)


def test_bmm_and_matmul_count_the_batch():
    c = count_costs(torch.bmm, _t(3, 5, 16), _t(3, 16, 7))
    assert c["flops"] == 2 * 3 * 5 * 16 * 7
    assert c["bytes"] == 2 * (3 * 5 * 16 + 3 * 16 * 7 + 3 * 5 * 7)
    c = count_costs(lambda a, b: a @ b, _t(2, 3, 5, 16), _t(16, 4))
    assert c["flops"] == 2 * 2 * 3 * 5 * 16 * 4


def test_index_put_counts_twice_the_moved_update():
    def write(cache, idx, rows):
        cache[idx] = rows

    c = count_costs(write, _t(64, 3, 8), torch.tensor([1, 5]),
                    _t(2, 3, 8))
    assert c["flops"] == 0
    assert c["bytes"] == c["bytes_unfused"] == 2 * (2 * 3 * 8 * 2)

    def slice_copy(cache, rows):
        cache[4:6] = rows  # a copy_ into a view

    c = count_costs(slice_copy, _t(64, 3, 8), _t(2, 3, 8))
    assert c["bytes"] == 2 * (2 * 3 * 8 * 2)


def test_cat_gather_and_embedding_count_twice_the_output():
    c = count_costs(lambda a, b: torch.cat([a, b], 0), _t(4, 8), _t(2, 8))
    assert c["bytes"] == 2 * (6 * 8 * 2)
    c = count_costs(lambda w, i: w[i], _t(100, 16), torch.tensor([3, 7]))
    assert c["bytes"] == 2 * (2 * 16 * 2)
    c = count_costs(torch.nn.functional.embedding,
                    torch.tensor([[1, 2, 3]]), _t(50, 8))
    assert c["bytes"] == 2 * (3 * 8 * 2)


def test_views_are_free_and_elementwise_unfused_only():
    c = count_costs(lambda x: x.view(4, 8).permute(1, 0)[2].unsqueeze(0)
                    .expand(3, 4), _t(32))
    assert c == {"flops": 0.0, "bytes": 0.0, "bytes_unfused": 0.0}
    c = count_costs(lambda x: torch.exp(x.float()) * 2, _t(32))
    assert c["bytes"] == 0 and c["bytes_unfused"] == 3 * 32 * 4


def test_einsum_counts_every_contraction_as_a_product():
    # torch lowers a contraction over a size-1 index to a mul: counted as
    # the reference's dot_general, 2 x the sizes of every index kept
    q, k = _t(1, 1, 4, 16, dtype=F32), _t(1, 1, 4, 8, dtype=F32)
    c = count_costs(lambda a, b: torch.einsum("bjnK,bjnh->bnKh", a, b),
                    q, k)
    assert c["flops"] == 2 * 4 * 16 * 8
    assert c["bytes"] == 4 * (4 * 16 + 4 * 8 + 4 * 16 * 8)
    # three operands, left to right: (w, k) -> bjnK, then with v
    w = _t(1, 1, 4, dtype=F32)
    c = count_costs(lambda a, b, v: torch.einsum("bjn,bjnK,bjnh->bnKh",
                                                 a, b, v), w, q, k)
    assert c["flops"] == 2 * 4 * 16 + 2 * 4 * 16 * 8
    # an ordinary contraction equals its bmm's count
    a, b = _t(2, 3, 5), _t(2, 5, 7)
    assert count_costs(lambda x, y: torch.einsum("bik,bkj->bij", x, y),
                       a, b) == count_costs(torch.bmm, a, b)


def test_fake_inputs_count_in_their_own_mode_without_storage():
    with fake_mode():
        big = torch.zeros((4096, 65536), dtype=BF)  # 512 MiB, not made
        w = torch.zeros((65536, 1024), dtype=BF)
    c = count_costs(torch.mm, big, w)
    assert c["flops"] == 2 * 4096 * 65536 * 1024


@pytest.mark.parametrize("arch", [
    a for a in list_archs()
    if a not in ("ibert-base", "moonshot-v1-16b-a3b",
                 "llama4-maverick-400b-a17b")])
def test_block_costs_match_reference(arch):
    check_block_costs(arch)
