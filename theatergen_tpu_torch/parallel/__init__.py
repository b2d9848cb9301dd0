"""Batched execution: a turn's characters and a wave's dialogues as one
batch on one device."""
