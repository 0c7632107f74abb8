"""Audio frontend (log-mel, frame embeddings) and ``transcribe``."""
