"""Fleet base: strategy, role maker and topology."""
