"""Glue of the pretrain entry point: seeding, logging, timing, checkpoints."""
