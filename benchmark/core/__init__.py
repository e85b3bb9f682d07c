"""What the cells share: finding a cell's files, the inputs and weights made
from the seed, the host spans and the profiler's reduction, the work counts
and the card's peaks, and the comparison that decides ``correct``."""
