"""The benchmark's plain reference: fp32 PyTorch forwards of each
configuration's shipped graph, read by a reader of its own. It imports
nothing of the program under test."""
