"""Inception-v3's eval forward and one SGD step against the reference on
the CPU, as ``test_torch_vision_zoo.py`` holds the other families (its
text gives the setting and the tolerances): a file of its own, so that
``--dist loadfile`` compiles this net's reference programs on another
worker than the rest of the zoo."""
import pytest

from test_torch_vision_zoo import check_eval_forward, check_sgd_step


@pytest.mark.parametrize("name", ["inception_v3"])
def test_eval_forward_matches_the_reference(name):
    check_eval_forward(name)


@pytest.mark.parametrize("name", ["inception_v3"])
def test_one_sgd_step_matches_the_reference(name):
    check_sgd_step(name)
