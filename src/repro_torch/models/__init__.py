"""The paper's models, in PyTorch."""
