import pytest


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test asks, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
