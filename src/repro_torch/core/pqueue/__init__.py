"""Tiered sharded priority-queue state, routing, schedules and batch ops."""
