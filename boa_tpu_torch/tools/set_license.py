"""Store the TotalSegmentator-style license number in the install config.

Counterpart of `boa_tpu/tools/set_license.py`
(`totalsegmentator/bin/totalseg_set_license.py:1-42`): checks the `aca_` +
18-character format and writes it to the port's install config
(utils/persistent_config.py); `--skip_validation` skips the validity check.
Run as `python -m boa_tpu_torch.tools.set_license -l aca_...`.
"""

from __future__ import annotations

import argparse

from boa_tpu_torch.utils.persistent_config import set_license_number, setup_config


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Set license.")
    parser.add_argument("-l", "--license_number", type=str, required=True,
                        help="TotalSegmentator license number.")
    parser.add_argument("-sv", "--skip_validation", action="store_true",
                        help="Do not evaluate if the license number is "
                             "valid.", default=False)
    args = parser.parse_args(argv)

    if not args.license_number.startswith("aca_"):
        raise ValueError("license number must start with 'aca_'")
    if len(args.license_number) != 18:
        raise ValueError("license number must have exactly 18 characters.")

    setup_config()  # create config file if not exists
    set_license_number(args.license_number,
                       skip_validation=args.skip_validation)
    print("License has been successfully saved.")


if __name__ == "__main__":
    main()
