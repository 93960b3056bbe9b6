"""Write `tests/fixtures/digits/digits_8x8.npz`: scikit-learn's
`load_digits` corpus (1797 real 8x8 handwritten digits, UCI's optical
recognition of handwritten digits, BSD-3 packaging) as `images` uint8
0-16 [1797, 8, 8] and `target` uint8 [1797]. The packaged LeNet
checkpoint was trained on these digits; the port's tests and
`chip_smoke.py` read this file, so neither needs scikit-learn.

    python tests/fixtures/make_digits_fixture.py
"""

import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "digits",
                   "digits_8x8.npz")


def digits():
    """(images uint8 [N, 8, 8], target uint8 [N]) from scikit-learn."""
    from sklearn.datasets import load_digits
    d = load_digits()
    return d.images.astype(np.uint8), d.target.astype(np.uint8)


def main():
    images, target = digits()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, images=images, target=target)
    print(f"{OUT}: {images.shape[0]} digits, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
