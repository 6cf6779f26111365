"""The port's command line: ``python -m mcpx_torch.cli`` (``cli/main.py``)."""
