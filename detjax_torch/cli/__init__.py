"""Command-line entry points of the port (``detjax/cli``):
``python -m detjax_torch.cli.{train,export,serve,detect,evaluate}``."""
