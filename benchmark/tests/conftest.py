import pytest
import torch


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs, never at
    import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
