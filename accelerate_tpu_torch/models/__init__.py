"""Model families of the port (slice 1: the llama family's cached decode)."""
