"""The port's decode-step counts against the reference's for the two MoE
configs, at full width (each ~25 s of fake counting: a file of their own,
so the test workers run them beside the others; tests/op_cost_cases.py
says what is equal and what parts)."""
import pytest

from op_cost_cases import check_block_costs


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_block_costs_match_reference(arch):
    check_block_costs(arch)
