"""Seed the install config with a given installation id.

Counterpart of `boa_tpu/tools/setup_manually.py`
(`totalsegmentator/bin/totalseg_setup_manually.py:1-37`): writes the id
(`boa_...` or `totalseg_...`) into the port's install config
(utils/persistent_config.py). Run as
`python -m boa_tpu_torch.tools.setup_manually -id totalseg_...`.
"""

from __future__ import annotations

import argparse

from boa_tpu_torch.utils.persistent_config import set_config_key, setup_config


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Setup config manually.")
    parser.add_argument("-id", "--totalseg_id", type=str, required=True,
                        help="installation id (boa_... or totalseg_...)")
    args = parser.parse_args(argv)

    if not args.totalseg_id.startswith(("boa_", "totalseg_")):
        raise ValueError("id must start with boa_ or totalseg_")
    setup_config()
    set_config_key("boa_tpu_id", args.totalseg_id)
    print(f"Installation id set to {args.totalseg_id}")


if __name__ == "__main__":
    main()
