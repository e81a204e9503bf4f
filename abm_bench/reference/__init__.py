"""The plain references: straightforward PyTorch, importing nothing of the
program and nothing of the harness."""
