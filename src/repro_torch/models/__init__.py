"""Model zoo: the ten architectures as one config-driven family (the port of
``repro.models``, serving path: forward, prefill, decode).

  layers.py      norms, RoPE/M-RoPE, GQA/SWA attention (chunked online
                 softmax — O(S·w) work for sliding windows), MLP
  moe.py         sort-based capacity MoE (gather-only dispatch)
  ssm.py         Mamba selective scan (chunked log-step scan) + the Hymba
                 parallel attn∥SSM head
  xlstm.py       chunkwise mLSTM + recurrent sLSTM superblocks
  transformer.py decoder-only assembly (attn/hymba/xlstm blocks, VLM merge)
  encdec.py      Whisper-style encoder–decoder
  model.py       params/init/apply, prefill/decode, input specs, ``LM``

Plain PyTorch throughout: the reference computes these in plain ``jnp``
(no Pallas kernel), and so does the port.
"""
