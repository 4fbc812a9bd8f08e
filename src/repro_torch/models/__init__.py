# The model stack: layers, GQA attention, RWKV-6 and the assembler
# (init, prefill, decode) for the attn+mlp and rwkv layer kinds.
