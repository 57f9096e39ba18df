"""Measurements of the card that the port's reports read: ``dma_ceiling``
(the random-row gather probe, its sweep and the achievable-rate reader)."""
