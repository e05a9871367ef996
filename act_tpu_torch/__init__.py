"""ACT on PyTorch and CUDA: the port of ``act_tpu`` to an NVIDIA H100.

The package imports ``torch`` and never JAX or ``act_tpu``; it mirrors
``act_tpu``'s module names. Its entry points run on the card unless the caller
passes ``device="cpu"``, where every CUDA kernel takes its plain PyTorch
version. It serves the finetuned PointTransformer classifier
(``engine/serve.py``, ``serve_http.py``) and trains Stage I, Stage II and the
finetune (``engine/runner_*.py``; the CLIs ``main_autoencoder.py`` and
``main.py``); it embeds features by t-SNE (``main_tsne.py``) and exports the
serving forwards as self-contained artifacts (``export_model.py``). The three
trainers run over several processes and cards (``parallel/``, launched by
``torch.distributed.run``) and stop at a step boundary on SIGTERM with a
checkpoint that ``--resume`` continues inside the epoch (``engine/preemption.py``).
"""
