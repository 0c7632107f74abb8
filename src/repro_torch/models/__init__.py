"""Whisper encoder-decoder model of the port."""
