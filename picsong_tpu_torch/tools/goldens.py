"""Test images, the SHA-256 digests and the quality rows that
`chip_smoke.py` holds the card's outputs to.

The digests and the lossy quality rows are those of the NumPy oracle
(`picsong_tpu.reference`) on the same inputs, the lossless quality rows
QUALITY.md's: `tests/test_torch_goldens.py` regenerates every one of them
on the CPU and asserts equality (the 2048^2 lossy rows in a test marked
slow: the oracle takes minutes a row there), so the card run needs
neither the oracle nor the JAX package. `make_image` is integer
arithmetic only (a product of triangle waves plus bounded uniform noise
from NumPy's PCG64), so it gives the same samples on every machine; its
own digests come first, so that a different input shows as "input
differs" and not as a codestream fault. The quality tools' images are
not integer arithmetic; their digests are checked the same way.
`aligned_counts` gives the codeblock sizes of X3's alignments batch.

    python -m picsong_tpu_torch.tools.goldens   # print the image digests
"""

from __future__ import annotations

import hashlib

import numpy as np

# 512^2 codestreams at BASELINE config 1 (wl=1, neutral LUT), by
# (coding passes, k): the one packed uint16 codestream
CODESTREAMS_512 = {
    (2, 0.0):
        'cf28858269d6546076ccb628914a22b07692545c42275603c1203d105f0a19d5',
    (3, 0.0):
        'a130814b06638eaebe2ff0246a6a1427d5cd344785152081082f468a24d10cbe',
    (2, 5.0):
        '5d3ff7a95c8be2d525ae38f9b0449728327bb0e7b591b98b5eb3fcd3738a41d0',
}
# 512^2 lossy 9/7, wl=3, qs=1, neutral LUT: codestream and decoded image
LOSSY_512 = {
    'codestream':
        '120378d8bd1319e4de5bf01db1e32f57c6811a679f5edabb431d358502943bd0',
    'decoded':
        'dafe8866e238ea0634c12dc58c6439a4103180a996abbc8d5c11d94ba4b71d4b',
}
# The first codeblock of every (level, subband) of the 2048^2 wl=5 gray
# lossless plane: block index -> digest of its int32 coefficients, then by
# (coding passes, k, LUT folder) the digest of the oracle's (stream words
# as int32, size as int32)
BLOCKS_2048 = {
    0:
        'fa58ef9efe6117aea5ccb446375734b3c183f6c66502200e19cab03163b42e22',
    1:
        'b96834d8ef583d52c071694d4def05da6427e2080c21d8dc076cc85fd14cff4d',
    2:
        '5617af92885ca9a36b22a81c54e2078db07e8599ef97a631aecacfc2375d3001',
    4:
        '4fbb0cc2ff805d5bd8cd1a3cad2b70e7badf1a95c7fc7a3977eb8fc3262f4268',
    8:
        '4f573c9cb38171217111f228688ecc95a8d3294d002a6c8101ace0c1c89fc7ce',
    16:
        '88f7a16714e60b814483f870327f901f9c0ab7b9076d7fbea2595781ba92e418',
    32:
        '540a14d3a02a9833efb22db4aadb080611edcd959c9625cb5b7892cee5ac2e9d',
    33:
        '349a0afeab8a731034e498ea3779c6e2ade54c1dd1860b3d11ad62f5b68891c2',
    64:
        'ca39a7158e2247ca770d31d7ce131bf04e83b097f615ba224704a06eae4c8424',
    66:
        '0e9f5d2127c41edecfdac5d77d3ba2e10115d66dd537b9e5d6b56f49ed2bb657',
    128:
        'bd346153a800c217d066b3e65ec705ce8ef6d8eeb965b2de7a0e42ed13a9122e',
    132:
        'ebd4c14c2dc81c860df6ade27ce0ee123fa089f8c1c7171c84fd8a38ec2a86fa',
    256:
        '63bebe98fd42780ac90c91bb4efd7d6055794ea2e15eeb87b8b213ea553c2ee2',
    264:
        '0a50a3713eac230d30c068e7829cedef7ac0e6f0008399e796e05569a43b7e43',
    512:
        '523661e06a4011521034d0195c50b0330583ace4c8ca785264a18c722aef250f',
    528:
        '3baeb0785904a1e5c54eeb11eab9b327b4db21d7df523e9c06a4dfcef096ca55',
}
PICKS_2048 = {
    (2, 0.0, 'neutral'): {
        0:
            '0a21a77773817be0daec265411103d43b603dcc10eaa9b2019ba568b37314387',
        1:
            'dbe1485ce41dcb84fa77616af132d5d7be5ef8b3dd8c998934948722779076be',
        2:
            '21c636b629f262cb4b0d48ec087f8c89de2f4cbe00b3a7822742a75de0f630d2',
        4:
            '6ace88f6b4595a4f84758e4e825d3641a7fe2c44577ad2201e3d21641578a308',
        8:
            '9376da78ae5f1736749f2532c46023f5d8891559d7610e604e42a0cbeef89000',
        16:
            '64127e980ed458153964cca7e4eaf9196f7bb35d463fe41d2254869f99dec784',
        32:
            '4e4a3451eb5374b34f36d562417226f5cc2906e9fc55df69add57ee6a15b7bc6',
        33:
            '267fb3094e32cab260027e20c3c1d7401684f148d17b94f7478d62e8879c8d38',
        64:
            '77d79432a223ca2fce84abd6125b7004929052b4530a26a066e534b9fa55817e',
        66:
            'd9ec504f522bd8dce4f045dff6fc6728eb92e8bb665fc28f56e43fdefff11fb0',
        128:
            'd55036374979a50e0d3c7685aea28e67bf84a334f60acdc9c29c4cb6484ea3f3',
        132:
            '8152c90f7c755d1dca5d478bfc092f098c82938a4de627e30e4f769f597e7912',
        256:
            '0d150d973fe789bfa49445a057b4b3dc6293976aed3e5b178caddb71eabe6867',
        264:
            '8d6f8fff6dd15e1ef753479a99951f929260758518d1bd4e761e6af5e25efe8e',
        512:
            '24efed8ca255a5ffae621bb64dad8b8a5fe4ae294b66a346952aa5124fb191d3',
        528:
            '8264035564825f7e0147982ef86e23fddcc3ede34a15299ad5b49b2d45d4779e',
    },
    (3, 0.0, 'neutral'): {
        0:
            '9bbb8a0ed20f0bebc6ce9e1e803fc91905c44a164960f7526d76dcc2b4ef9f05',
        1:
            '06ba858f0c89357beb62641231cd29d9ccf37f9b2a5c0dcc28c46f8c8608ecb6',
        2:
            '915a2bef8dc49e20d6ce9b99993ad63ef0eb41093d0ab3bc03aca8c3bc60f52e',
        4:
            'ba1ecbe4de224444e067f38f0f956b9767d4eb06e19b2eda298045a243976ad8',
        8:
            '5dc7474bc2d73b738782d665ebd9621edd042d6ec6b613e9cf3034e5195886c2',
        16:
            '1487a6c79998b8df60109687856841e0dca1272f10a5fc3f0b6f7996b9cb09d0',
        32:
            'e22340c316742f81b212975be43d88e699a434fa8d79704d8741dd6f0bde6a7a',
        33:
            '9a0d45f37123408ac85b9290a30fe60d765959306a301195f599d887a5aaa0fe',
        64:
            'a24c32f16cef13795de4d755258dff5a6b59547c506307e99bfdd5a5bc41119c',
        66:
            'f7bdbb625cb06b14795e869781c2927ed1fb7f185e2c3ff85dcd9e88c7071e6f',
        128:
            'c41bbf584e92db61e545e4b047c28b21006113c59390a58fa09e48f440f018fc',
        132:
            '69cc0dc9707c3e27124318f73c522d9d273f9335263a97574ccf8d9586a22b2a',
        256:
            '66ad44fe69b545a9b13d90e693aeb1c7dd36661ef3611a0ed203e644a07817dc',
        264:
            '5622dc357252978ebc9255cbaf5fc7f0a5273b4cd49ca5c55e665c91cbf653e1',
        512:
            'c42f20fbefffd93a629d8c131465fbb0e5e0b9b59586568fb4f31a3d8d95fc47',
        528:
            'e54b73aa0ff958baa0168ba412ad5b32f6062e27e7f9a37c79da8500c9a91777',
    },
    (3, 0.0, 'trained'): {
        0:
            '82ffb17578a7d7bd1dcce3d7b6ec562053816a67e53a31e41cd573f770bb3271',
        1:
            '045828d675a6a076c3ee6de7a59a264d1e4617e198f13b1ec8644fc79ee2710b',
        2:
            'bb930e9b5bba69dbf001424942d80502e76242bb0122c531e41624720ee3a2ce',
        4:
            'e55cbe4c5fb8546f16eebe484c27c884d645e22c7b67097a986ca11baa4134e2',
        8:
            'ab5a058848d3d4946e5efea9bb8fd5c94afff171d36576dfe59cc2935508da46',
        16:
            '935c032bed51e8762927ab7b69170308d52b71d45896fd225e759bfa83f5e4bb',
        32:
            '0b84587a90c55f9b760c6217d07d2f64054a5f7e1a6e45ea45d0e9eb059f76e7',
        33:
            '1074249332148cb2915b177df7c3e11eb100aa857769d43f61ceecbcef2271db',
        64:
            '54e35ee47c2d811104bf8c8938b46992422c71a062c9bf178c9813a185eb7c0f',
        66:
            'a97fcdbee769bf338bfe0cd9f35ae056b174ed89e18bd83e30436e62e3f3b942',
        128:
            '18fdaaf71bffbfdd38f5d65e3f621b18760c788d2bbde3c87691e73f006a8ff0',
        132:
            '5684a9e73c2ddde0f93b66e77330c88c444c9f5e8f7cd4de325af8ce6ede9232',
        256:
            '270965f89234b05af664e8f7179d44495e011113e5669746cc33641a68200c91',
        264:
            'ebef06ad65088a9fe4e31e6ca99f524a7b9b9c669878cdeee73ca54cf2d2a04e',
        512:
            '3fbe1bf0cc5a9246e7c18dbbd0d211ce8e06989a21fa2788d91adcc292999742',
        528:
            '21e28af27d90ff8aaddb65fb3c2c430d838672dedf5b8f843683cb6f29d7bbab',
    },
    (2, 5.0, 'neutral'): {
        0:
            '0a21a77773817be0daec265411103d43b603dcc10eaa9b2019ba568b37314387',
        1:
            'a861b4ed5b5fe0127e750243625c9a4d5f044fd3121922aa8f9cd08838bbc5a4',
        2:
            'a5c28903db912e92e61345c91ba4b61deee751dfe5540015b8fc9db05c960173',
        4:
            'd315d28bbd2b7304c562067cbfd7cb013517dd73088d843ed7ea0648258b9418',
        8:
            '316121a77536fb43d725f5e5706ac532c6d2a67d60b451c9e1ef44cb1c8818d8',
        16:
            '6ad25d4fcaf94df5830db63a6b257d6b5e19d5ac21121e07ae8da03fe2c11169',
        32:
            'ac1c0a67b830bf37c97b21f8268aff1fafe7b37ee52de273ced445e2c74f22f8',
        33:
            '21ea12856eadda3fd7f50e97e697031ab4b52d9842d9fdd25999d858b2c3d1a5',
        64:
            '7ea6d28b2a8c856e9072b16a703f9f83c31cd7aa651055af1ef875bab505c906',
        66:
            '3e772fb9bef5b3b22de2cbad3eb60db86a6504f9e8cb4f2ceac19cbd02d19945',
        128:
            '224d02c592a32ad849781714d226d516cb23ec054ed687893c79f2d9205e3b44',
        132:
            'c1f6858ec4105a99128c4e0c1b0c3d493829418dc1678a1d6ee2fe82c289ce5f',
        256:
            '0c80cc8f972dfc22fad380452cfc02cbe598c0c00eb3e74238b15cb2f9cebdaa',
        264:
            'e15a2c3c883435b6c33c41c6e46a4570ebe3762f4a1969d776fae1bd81495fb7',
        512:
            '3e0f5fc28754e0adbd64862286886e21d43a2fa0b7d906f12ff4fe3100f80f31',
        528:
            '545e2ab6c4ab9810f99caa914ea4583b56f85c2dccdfc9682a9e7204554edf10',
    },
    (2, 5.0, 'trained'): {
        0:
            '1455d70b3d71c755c3f915ae5fe96dc8518315c3cf8575cb4b9b7558523fe94b',
        1:
            '05fdcef6ae8d59a45570aa0cb221b4a6e1e833e328c76adbebec67e97791fd5a',
        2:
            '19f242e7454a08655cdcbe64c780bf0389faa76c3075a416c3fe197907a43952',
        4:
            'c4b9883f58682dcfff283f8be825f14c1a927050c4756778dc48bacf0ed858b4',
        8:
            'e3bdddd65646a75d6408b67653fbef8f034a176d21ec9f423a0674c19eff904a',
        16:
            '8fbcd0551d24dda6c8a3baefb022c4b6f700086a5a6d8c7c78320924b002a9df',
        32:
            '62d2e3a389c2b91e5ffde1e85f2ac1495511f6a738239f3ecf2c5441faecb767',
        33:
            'f42927ad20187f0d44ff0f05cb3f08dafac182ed903d72781015cd959b7f7ad0',
        64:
            '87d133a3b366a97b9d9eaba8a481a5213c342cbdde64e24d71c3ca5c58bb10a7',
        66:
            'b6051a31f500152bebf213ffdabf7e422bbf19f6290e6c206be4dce240eb05e5',
        128:
            '6f749e66e2152b9f9e18417b5b046e7fc0e66bd4f8f72ceaf3277d0be54b2b61',
        132:
            '15ce72a54a4fc78bbe9223f237b5ee29d401a2843651766f994355597ab7a2e8',
        256:
            'f91b02356a720cd00730d53830f0238c19492e80315eedb3d9c0eedc165d5661',
        264:
            '930318752aa0ba40ee61cedd07e9da1aa9b0d17c3f9dc057569993e85d12fb7e',
        512:
            '2e3ce76d6bcca284e9b67cfbf800dd4ee74193871a42f15ac3b9b715b098b19c',
        528:
            '4e56f91c7bca7916ebfdaabc8d3ef6140bccd7dfa0cc8513da6183f4d283927a',
    },
}
# digests of make_image's samples, by (size, seed, width, peak)
IMAGES = {
    (512, 3, 512, 255):
        '47433cf327c9439645c7794dd815c13af2ab856b65d96aa419ac3eefb577053a',
    (2048, 3, 2048, 255):
        '00290d685055fbf10a06037cf6b6c856ab043c643c5c0306bdaf35d56fb4d883',
}

# The quality tools' held-out images (`tools/quality_report.py`:
# natural, noisy, edges; made with floating point: FFT, sin, cos, normal
# draws, so another NumPy build may round a sample differently), by
# (image, size)
QUALITY_IMAGES = {
    ('natural', 512):
        '56af02b227e4955d32e12ddea073a61812e7e570907914e0af60866e2bf19d9a',
    ('noisy', 512):
        '4e66f346b73a602fa0a36fb1505e23ae280f9fecebbce39b7cf3ed4d2049b11d',
    ('edges', 512):
        '14e3f0f851d11ecdebb41a4c95cb1f573acec632f9b800fc51fb8d8b596d6afb',
    ('natural', 2048):
        'da04de58905b43dea1f3b5609bca304eea58056f6637c568433e3db35c1ff243',
}
# QUALITY.md's lossless rows (5/3, wl=5, cp=2): codestream bytes by
# (image, size, LUT table); the oracle's bytes too
QUALITY_LOSSLESS = {
    ('natural', 512, 'neutral'): 154410,
    ('natural', 512, 'trained'): 112218,
    ('noisy', 512, 'neutral'): 215286,
    ('noisy', 512, 'trained'): 179432,
    ('edges', 512, 'neutral'): 258694,
    ('edges', 512, 'trained'): 132678,
    ('natural', 2048, 'neutral'): 2420542,
    ('natural', 2048, 'trained'): 1790102,
}
# The oracle's lossy rows of the natural image (9/7, wl=5, trained lossy
# LUT): (codestream bytes, PSNR in dB to two decimals) by (size, qs)
QUALITY_LOSSY = {
    (512, 0.01): (828, '39.61'),
    (512, 0.05): (970, '41.75'),
    (512, 0.1): (1358, '41.89'),
    (512, 0.25): (21050, '43.18'),
    (512, 0.5): (58106, '48.25'),
    (512, 1.0): (98268, '54.55'),
    (2048, 0.05): (8926, '41.93'),
    (2048, 0.25): (319730, '43.19'),
    (2048, 0.5): (915550, '48.24'),
    (2048, 1.0): (1558620, '54.53'),
}


def digest(*arrays) -> str:
    """SHA-256 of the arrays' bytes, in order, after a cast to a
    little-endian fixed type of each array's kind."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes())
    return h.hexdigest()


def _tri(t: np.ndarray, period: int) -> np.ndarray:
    """A triangle wave in [-period, period]."""
    return np.abs((t % period) * 4 - 2 * period) - period


def _pattern(height: int, width: int, seed: int, dx: int = 0,
             dy: int = 0) -> np.ndarray:
    """120 + 70 * tri(x + dx) * tri(y + dy) (the waves' periods 69 and 107
    samples) plus uniform noise in [-10, 10] (sigma ~6), as int64."""
    px, py = 69, 107
    tx = _tri(np.arange(width, dtype=np.int64) + dx, px)
    ty = _tri(np.arange(height, dtype=np.int64) + dy, py)
    rng = np.random.default_rng(seed)
    noise = rng.integers(-10, 11, size=(height, width), dtype=np.int64)
    return (120 * px * py + 70 * ty[:, None] * tx[None, :]) // (px * py) \
        + noise


def make_image(size: int, seed: int = 3, width: int | None = None,
               peak: int = 255) -> np.ndarray:
    """The pattern with its noise, 8-bit, or scaled to `peak` as uint16;
    integer arithmetic only."""
    img = (_pattern(size, width or size, seed) * peak) // 255
    return np.clip(img, 0, peak).astype(np.uint8 if peak == 255
                                        else np.uint16)


def make_frame(height: int, width: int, index: int,
               seed: int = 3) -> np.ndarray:
    """Frame `index` of a test video, 8-bit: the pattern moved by 3
    samples a frame to the left and 2 up, with the frame's own noise
    (seed + index); integer arithmetic only."""
    img = _pattern(height, width, seed + index, 3 * index, 2 * index)
    return np.clip(img, 0, 255).astype(np.uint8)


def aligned_counts() -> list[int]:
    """Payload counts of 304 codeblocks (their payload starts at short
    9 + 2 * 304 of the codestream) under which the first payload short of
    a block with each of the counts 0-17 and 4095 lies at every residue
    mod 8, each 2-byte place of a 16-byte chunk: before each such block, a
    lead block sized to put it there. X3's alignments batch."""
    n = 2 * 8 * 19
    body, off, counts = 9 + 2 * n, 0, []
    for c in (*range(18), 4095):
        for r in range(8):
            lead = (r - body - off) % 8
            counts += [lead, c]
            off += lead + c
    return counts


def image_key(size: int, seed: int = 3, width: int | None = None,
              peak: int = 255) -> tuple:
    return (size, seed, width or size, peak)


def main() -> int:
    from . import quality_report

    for key in sorted(IMAGES):
        size, seed, width, peak = key
        got = digest(make_image(size, seed, width, peak))
        print(key, got, "ok" if got == IMAGES[key] else "DIFFERS")
    for key in sorted(QUALITY_IMAGES):
        got = digest(quality_report.image(*key))
        print(key, got, "ok" if got == QUALITY_IMAGES[key] else "DIFFERS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
