import pytest


@pytest.fixture
def card():
    """Skip unless an NVIDIA card is present (decided in the test, never
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
