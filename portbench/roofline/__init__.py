"""Peaks, and the operations and bytes each measured piece of work needs,
counted from shapes and from the work the inputs need (never from what an
implementation happens to do)."""
