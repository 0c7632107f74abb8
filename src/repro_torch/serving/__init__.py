"""Slot-pool serving engine, lane-state ledger and batch scheduler."""
