"""Serving example: JPEG bytes -> logits, end to end.

  python examples/serve.py image1.jpg image2.jpg ...
  python examples/serve.py --quantize auto image1.jpg    # the int8 mode vitax picks (w8)
  python examples/serve.py --quantize w8a8 image1.jpg    # int8 encoder GEMMs
  python examples/serve.py --quantize w8 image1.jpg      # weight-only int8

Host side: native multithreaded libjpeg decode + bilinear resize
(vitax.data.JpegDecoder, C++ via ctypes, PIL fallback). Device side:
resize/crop/normalize fused into the same XLA program as the model
(vitax.pipeline.InferencePipeline) so one dispatch serves the request.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np


def main():
    args = sys.argv[1:]
    quantize = None
    if args and args[0] == "--quantize":
        quantize = args[1]
        args = args[2:]
    paths = args
    from vitax.data import JpegDecoder, classify_jpegs
    from vitax.models import ViT
    from vitax.pipeline import InferencePipeline

    model = ViT(
        image_size=224, patch_size=16, num_classes=1000, dim=768,
        depth=12, heads=12, mlp_dim=3072, dtype=jnp.bfloat16,
    )
    img = jnp.zeros((1, 224, 224, 3), jnp.uint8)
    variables = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                           jnp.zeros((1, 224, 224, 3), jnp.bfloat16)))()

    apply_fn = None
    if quantize in ("w8a8", "auto"):
        # int8 encoder GEMMs (dedicated ViT path: ops/quant.py)
        from vitax.utils.quantize import quantize_vit, vit_apply_w8a8

        variables = quantize_vit(variables)
        apply_fn = lambda v, x: vit_apply_w8a8(model, v, x, mode=quantize)
    elif quantize == "w8":
        # generic weight-only compression (works on any family)
        from vitax.utils.quantize import quantize_weights, quantized_apply

        variables = quantize_weights(variables)
        apply_fn = lambda v, x: quantized_apply(model, v, x, dtype=jnp.bfloat16)
    elif quantize is not None:
        raise SystemExit(f"unknown --quantize mode {quantize!r}")

    pipe = InferencePipeline(model, variables, image_size=224, apply_fn=apply_fn)

    if paths:
        jpegs = [open(p, "rb").read() for p in paths]
    else:
        # demo: encode one synthetic image
        from io import BytesIO

        from PIL import Image

        buf = BytesIO()
        Image.fromarray(
            (np.random.default_rng(0).random((256, 256, 3)) * 255).astype(np.uint8)
        ).save(buf, format="JPEG")
        jpegs = [buf.getvalue()]
        print("(no paths given — classifying one synthetic JPEG)")

    logits = classify_jpegs(pipe, jpegs)
    for p, row in zip(paths or ["<synthetic>"], logits):
        top = np.argsort(row)[-3:][::-1]
        print(f"{p}: top-3 classes {top.tolist()}")


if __name__ == "__main__":
    main()
