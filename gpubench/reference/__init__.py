"""Plain PyTorch references of what the benchmark's cells serve.

Each module here restates one configuration family's arithmetic in
float32 torch operations, from the published description and the
repository's documented contracts, and imports nothing of the program
under test: the benchmark hands it the same seeds and float weights it
hands the program, and it works out again everything the program
derives from them (wire bytes, int8 codes, anchors, crops).
"""
