"""Host runtime helpers of the port (the Huffman bit codec)."""
