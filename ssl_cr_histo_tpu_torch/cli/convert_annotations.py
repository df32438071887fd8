"""Convert official Camelyon16 ASAP XML annotations to the internal JSON
format: the port's copy of ``ssl_cr_histo_tpu/cli/convert_annotations.py``
(the reference exposes this as util.Formatter.camelyon16xml2json;
users run it once before building the patch datasets).

Usage:
    python -m ssl_cr_histo_tpu_torch.cli.convert_annotations \
        --xml_dir <dir of .xml> --json_dir <output dir>
"""

from __future__ import annotations

import argparse
import glob
import os

from ssl_cr_histo_tpu_torch.data.annotations import camelyon16xml2json


def main(argv=None):
    p = argparse.ArgumentParser("Camelyon16 XML -> JSON annotation converter")
    p.add_argument("--xml_dir", required=True)
    p.add_argument("--json_dir", required=True)
    args = p.parse_args(argv)

    os.makedirs(args.json_dir, exist_ok=True)
    xmls = sorted(glob.glob(os.path.join(args.xml_dir, "*.xml")))
    if not xmls:
        raise SystemExit(f"no .xml files under {args.xml_dir}")
    for inxml in xmls:
        name = os.path.splitext(os.path.basename(inxml))[0]
        outjson = os.path.join(args.json_dir, f"{name}.json")
        camelyon16xml2json(inxml, outjson)
        print(f"{inxml} -> {outjson}")
    print(f"converted {len(xmls)} annotations")


if __name__ == "__main__":
    main()
