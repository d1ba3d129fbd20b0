"""Prosody measurement and adjustment math, in PyTorch."""
