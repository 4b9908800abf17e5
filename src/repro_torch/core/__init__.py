"""Core of the port: the tiered PQ state, schedules, classifier, SmartPQ."""
