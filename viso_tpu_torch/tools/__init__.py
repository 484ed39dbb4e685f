"""Command-line tools of the port (run with `python -m viso_tpu_torch.tools.<name>`)."""
