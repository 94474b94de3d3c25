"""joinbench's tests. Those marked ``card`` need a CUDA card and skip
without one; whether there is a card is decided in a fixture, when a test
runs."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _card_only(request):
    if request.node.get_closest_marker("card") and \
            not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
