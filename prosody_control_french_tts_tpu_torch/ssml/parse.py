"""SSML → training-data JSON (the reference's export format).

Parses the syntagme-level CSV rows back into the
``{x, y:{parsed_sequence, stripped_ssml, raw_ssml}}`` schema consumed by
every model in the reference (Code/Pipeline/create_training_data.py:26-156;
``bdd.json`` feeds pause_bert, bilstm, the few-shot harness and the Qwen
cascade).
"""

from __future__ import annotations

import json
import re
import xml.etree.ElementTree as ET
from pathlib import Path

SSML_NS = "http://www.w3.org/2001/10/synthesis"
_SPEAK_BLOCK = re.compile(r"(<speak.*?</speak>)", re.DOTALL)


def clean_ssml_str(ssml_string: str) -> str:
    """Strip xmlns declarations and namespace prefixes
    (create_training_data.py:16-24)."""
    ssml_string = re.sub(r'\sxmlns(:\w+)?="[^"]+"', "", ssml_string)
    return re.sub(r"\w+:(prosody|break)", r"\1", ssml_string)


def parse_training_rows(rows: list[dict]) -> dict:
    """rows: [{segment, syntagme, pause, ssml}] (the BDD_syntagme_ssml.csv
    shape) → training JSON dict (create_training_data.py:26-123)."""
    combined_texts: list[str] = []
    parsed_sequence: list[dict] = []
    raw_ssml: dict[str, list[str]] = {}
    stripped_ssml: dict[str, list[str]] = {}

    for row in rows:
        seg = str(row["segment"]).strip()
        syntagme = str(row.get("syntagme", "") or "").strip()
        ssml_full = str(row["ssml"]).strip()

        if syntagme:
            combined_texts.append(syntagme)
        raw_ssml.setdefault(seg, []).append(ssml_full)
        stripped_ssml.setdefault(seg, [])

        for block in _SPEAK_BLOCK.findall(ssml_full):
            root = ET.fromstring(block)
            voice = root.find(f".//{{{SSML_NS}}}voice")
            if voice is None:
                continue
            prosody = voice.find(f".//{{{SSML_NS}}}prosody")
            if prosody is None:
                continue
            pitch = prosody.get("pitch", "")
            rate = prosody.get("rate", "")
            volume = prosody.get("volume", "")

            if prosody.text and prosody.text.strip():
                parsed_sequence.append(
                    {
                        "segment": seg,
                        "type": "text",
                        "text": prosody.text.strip(),
                        "prosody": {"pitch": pitch, "rate": rate, "volume": volume},
                    }
                )
                raw = ET.tostring(prosody, encoding="unicode", method="xml")
                stripped_ssml[seg].append(clean_ssml_str(raw))

            for child in prosody:
                tag = child.tag.split("}")[-1]
                if tag == "break":
                    parsed_sequence.append(
                        {"segment": seg, "type": "break", "time": child.get("time", "")}
                    )
                    raw = ET.tostring(child, encoding="unicode", method="xml")
                    stripped_ssml[seg].append(clean_ssml_str(raw))
                if child.tail and child.tail.strip():
                    parsed_sequence.append(
                        {
                            "segment": seg,
                            "type": "text",
                            "text": child.tail.strip(),
                            "prosody": {"pitch": pitch, "rate": rate, "volume": volume},
                        }
                    )

    if not parsed_sequence:
        raise ValueError("No SSML elements found in rows.")

    return {
        "x": " ".join(combined_texts).strip(),
        "y": {
            "parsed_sequence": parsed_sequence,
            "stripped_ssml": stripped_ssml,
            "raw_ssml": raw_ssml,
        },
    }


def write_training_json(rows: list[dict], output_path: str | Path) -> dict:
    out = parse_training_rows(rows)
    p = Path(output_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, ensure_ascii=False, indent=2), encoding="utf-8")
    return out


def combine_training_data(results_folder: str | Path, combined_json_path: str | Path) -> dict:
    """Merge every voice folder's training_data_*.json into one bdd.json
    (create_training_data.py:125-156)."""
    results_folder = Path(results_folder)
    combined: dict[str, dict] = {}
    if not results_folder.is_dir():
        return combined
    for folder in sorted(p for p in results_folder.iterdir() if p.is_dir()):
        merged = {"x": "", "y": {"parsed_sequence": [], "stripped_ssml": {}, "raw_ssml": {}}}
        for fn in sorted(folder.iterdir()):
            if fn.name.startswith("training_data_") and fn.suffix == ".json" and fn.name != "bdd.json":
                data = json.loads(fn.read_text(encoding="utf-8"))
                merged["x"] += data.get("x", "") + " "
                merged["y"]["parsed_sequence"].extend(data["y"].get("parsed_sequence", []))
                for seg, lst in data["y"].get("stripped_ssml", {}).items():
                    merged["y"]["stripped_ssml"].setdefault(seg, []).extend(lst)
                for seg, lst in data["y"].get("raw_ssml", {}).items():
                    merged["y"]["raw_ssml"].setdefault(seg, []).extend(lst)
        merged["x"] = merged["x"].strip()
        combined[folder.name] = merged
    Path(combined_json_path).write_text(
        json.dumps(combined, ensure_ascii=False, indent=2), encoding="utf-8"
    )
    return combined
